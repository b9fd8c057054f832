"""The port's fused build -> whiten -> accumulate chain
(gpitch_tpu_torch/linalg/fused_whiten.py) against the JAX prototypes it
replaces: scripts/proto_fused_whiten.py (``xla_reference``, ``make_fused``,
``make_fused_mxu``) and scripts/proto_fused_whiten_bwd.py
(``make_fused_bwd``), the Pallas kernels in interpret mode.

Small shapes: 3 windows, M 16, S 2, P 3.  The prototypes need N to be a
multiple of ``tile_t`` (a ragged last tile reads past the end and gives
NaN), so they run at N 256; the port's plain versions also run at a
ragged N 300 against ``xla_reference``.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpitch_tpu_torch.core.params import named_params
from gpitch_tpu_torch.kernels import MercerMatern12sm
from gpitch_tpu_torch.pipelines import windowed_sgpr as tws
from fused_whiten_inputs import prototype_inputs

# the module, which the package's function of the same name shadows
fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import proto_fused_whiten as pfw  # noqa: E402
import proto_fused_whiten_bwd as pfwb  # noqa: E402

NW, M, S, P, FS = 3, 16, 2, 3, 16000.0


def _inputs(n, per_window=False, seed=0):
    return prototype_inputs(NW, M, n, S, P, per_window, seed, FS)


def _cotangents(seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((NW, M, M)) * 0.01, rng.standard_normal((NW, M, 1)) * 0.01


def _t(arrays, dtype=torch.float64):
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype) for a in arrays]


def _j(arrays, dtype=jnp.float64):
    return [jnp.asarray(a, dtype=dtype) for a in arrays]


def _flat(energy, freq, var, inv_l):
    """make_fused's (1, S (2P + 2)) parameter row."""
    return np.concatenate([np.concatenate([energy[s], freq[s], [var[s]], [inv_l[s]]])
                           for s in range(S)])[None]


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _xla_per_window(args):
    """xla_reference, one call per window when the parameters are per
    window; numpy outputs."""
    zc, xc, err, linv, e, f, v, il = args
    if e.ndim == 2:
        return [np.asarray(o) for o in pfw.xla_reference(*_j(args))]
    outs = [pfw.xla_reference(*_j((zc[w:w + 1], xc[w:w + 1], err[w:w + 1],
                                   linv[w:w + 1], e[w], f[w], v[w], il[w])))
            for w in range(NW)]
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(2)]


@pytest.mark.parametrize("per_window", [False, True])
def test_fused_whiten_plain_matches_xla_reference_f64(per_window):
    """f64 at a ragged N 300: the same composition, 1e-12 of max|ref|."""
    args = _inputs(300, per_window)
    u, v = fw.fused_whiten_plain(*_t(args))
    want_u, want_v = _xla_per_window(args)
    close(u, want_u, 1e-12)
    close(v, want_v, 1e-12)


@pytest.mark.parametrize("proto", ["make_fused", "make_fused_mxu"])
def test_fused_whiten_f32_matches_pallas_prototypes(proto):
    """f32 at N 256 (tile_t 128, win_tile 2, interpret mode) against both
    forward prototypes; the port's plain forward and its entry point for
    that prototype's argument form, 3e-5 of max|ref| (f32 sums over N)."""
    args = _inputs(256)
    zc, xc, err, linv, e, f, v, il = args
    tiling = dict(tile_t=128, win_tile=2, interpret=True)
    if proto == "make_fused":
        want = pfw.make_fused(S, P)(*_j((zc, xc, err, linv, _flat(e, f, v, il)),
                                        jnp.float32), **tiling)
        port = fw.fused_whiten_flat(*_t((zc, xc, err, linv, _flat(e, f, v, il)),
                                        torch.float32), num_sources=S)
    else:
        want = pfw.make_fused_mxu(S, P)(*_j(args, jnp.float32), **tiling)
        port = fw.fused_whiten(*_t(args, torch.float32))
    plain = fw.fused_whiten_plain(*_t(args, torch.float32))
    for got in (plain, port):
        for g, w in zip(got, want):
            close(g, w, 3e-5)


def test_fused_whiten_bwd_plain_matches_jax_grad_f64():
    """The backward's own formulas against jax.grad of xla_reference, f64,
    1e-10 of max|ref| per output (summed over windows, as the parameters
    are shared)."""
    args = _inputs(300)
    zc, xc, err, linv, e, f, v, il = _j(args)
    du, dv = _cotangents()

    def scalar(linv_, e_, f_, v_, il_):
        u, vv = pfw.xla_reference(zc, xc, err, linv_, e_, f_, v_, il_)
        return jnp.sum(u * du) + jnp.sum(vv * dv)

    want = jax.grad(scalar, argnums=(0, 1, 2, 3, 4))(linv, e, f, v, il)
    dlinv, dvar, dinvl, de, df = fw.fused_whiten_bwd_plain(
        *_t(args[:4]), *_t((du, dv)), *_t(args[4:]))
    for got, ref in zip((dlinv, de.sum(0), df.sum(0), dvar.sum((0, 1)),
                         dinvl.sum((0, 1))), want):
        close(got, ref, 1e-10)


def test_fused_whiten_bwd_f32_matches_pallas_prototype():
    """f32 against make_fused_bwd in interpret mode (tile_t 128), per
    window: 2e-4 of max|ref| (the prototype's own dinvl error against f64
    is 4.2e-5)."""
    args = _inputs(256)
    du, dv = _cotangents()
    ins = args[:4] + (du, dv) + args[4:]
    want = pfwb.make_fused_bwd(S, P)(*_j(ins, jnp.float32), tile_t=128,
                                     win_tile=1, interpret=True)
    got = fw.fused_whiten_bwd(*_t(ins, torch.float32))
    for name, g, w in zip(("dlinv", "dvar", "dinvl", "de", "df"), got, want):
        assert g.shape == w.shape, name
        close(g, w, 2e-4)


def _leaves(args):
    ts = _t(args)
    for t in ts[3:]:
        t.requires_grad_(True)
    return ts


def test_fused_whiten_gradcheck_f64():
    """torch.autograd.gradcheck of the Function (the plain backward's
    formulas on the CPU) in linv and the four parameters, f64, N 40.
    max|U| is ~200, so central differences at eps 1e-6 carry ~1e-8 of
    rounding: atol 1e-6."""
    args = _inputs(40)
    ts = _leaves(args)
    assert torch.autograd.gradcheck(lambda *a: fw.fused_whiten(*ts[:3], *a),
                                    ts[3:], eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("per_window", [False, True])
def test_fused_whiten_grads_match_autograd_of_plain(per_window):
    """The Function's gradients (plain backward formulas, reduced over the
    windows for shared parameters) against autograd through the plain
    forward, f64, 1e-10 of max|ref|; the flat entry gives the same."""
    args = _inputs(300, per_window)
    du, dv = _t(_cotangents())
    grads = []
    for fn in (fw.fused_whiten, fw.fused_whiten_plain):
        ts = _leaves(args)
        u, v = fn(*ts)
        ((u * du).sum() + (v * dv).sum()).backward()
        grads.append([t.grad for t in ts[3:]])
    for got, ref in zip(*grads):
        close(got, ref.numpy(), 1e-10)
    if not per_window:
        zc, xc, err, linv, e, f, v, il = args
        flat = torch.as_tensor(_flat(e, f, v, il)).requires_grad_(True)
        uf, vf = fw.fused_whiten_flat(*_t((zc, xc, err, linv)), flat, num_sources=S)
        u, v = fw.fused_whiten_plain(*_t(args))
        close(uf, u.numpy(), 1e-12)
        close(vf, v.numpy(), 1e-12)
        ((uf * du).sum() + (vf * dv).sum()).backward()
        r = flat.grad.reshape(S, 2 * P + 2)
        for got, ref in zip((r[:, :P], r[:, P:2 * P], r[:, 2 * P], r[:, 2 * P + 1]),
                            grads[1][1:]):
            close(got, ref.numpy(), 1e-10)


def _bank(nw=3, dtype=torch.float64):
    """An ``nw``-window port bank (ws 201, M 16, S 3, P 4) on the CPU."""
    rng = np.random.default_rng(5)
    ws, m = 201, 16
    n = ws + (nw - 1) * 100
    x = np.arange(n) / FS + 2.0
    y = np.sin(2 * np.pi * 300 * x) + 0.1 * rng.standard_normal(n)
    idx = np.arange(nw)[:, None] * 100 + np.arange(ws)[None, :]
    zw = np.stack([np.sort(rng.choice(x[idx[i]], m, replace=False)) for i in range(nw)])

    def kern():
        ks = []
        for i in range(3):
            e = np.linspace(1.0, 0.3, 4)
            ks.append(MercerMatern12sm.create(0.6 + 0.3 * i, 0.05 + 0.03 * i, e / e.sum(),
                                              (220.0 + 60.0 * i) * np.arange(1, 5),
                                              dtype=dtype))
        return tws.sum_kernel(ks)

    return tws.build_window_bank(x[idx], y[idx], zw[..., None], kern,
                                 grid_dt=1 / FS, dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bank_linv_is_exactly_lower_triangular(dtype):
    """Kernel A reads Linv's lower triangle only (csrc/fused_whiten.cu):
    the Linv that a bank's bound hands the pair (chol_inv's, through
    fused_whiten_args) has an exactly zero strict upper triangle, on a
    seeded 4-window bank in f32 and f64."""
    bank = _bank(nw=4, dtype=dtype)
    assert bank.fused_eligible()
    linv = bank.fused_whiten_args()[3].detach()
    assert tuple(linv.shape) == (4, 16, 16) and linv.dtype == dtype
    assert bool(torch.isfinite(linv).all())
    assert float(torch.triu(linv, 1).abs().max()) == 0.0
    assert bool((torch.diagonal(linv, dim1=-2, dim2=-1) > 0).all())


def test_fused_whiten_on_a_bank_matches_its_bound():
    """On a port bank: U / sigma^2 is _common_unfused's AAT and v its Aerr
    (1e-12), and for a seeded (dU, dv) the scalar <U, dU> + <v, dv> through
    fused_whiten and through _common_unfused's A gives the same gradient in
    every trainable raw leaf (1e-10)."""
    bank = _bank()
    err, _, _, A, AAT, _, _, sigma2 = bank._common_unfused()
    u, v = fw.fused_whiten(*bank.fused_whiten_args())
    close(u / sigma2, AAT.detach().numpy(), 1e-12)
    close(v, (A @ err).detach().numpy(), 1e-12)
    rng = np.random.default_rng(7)
    du = torch.as_tensor(rng.standard_normal(u.shape))
    dv = torch.as_tensor(rng.standard_normal(v.shape))
    grads = []
    for route in ("fused", "common"):
        bank = _bank()
        if route == "fused":
            u, v = fw.fused_whiten(*bank.fused_whiten_args())
        else:
            err, _, _, A, *_ = bank._common_unfused()
            u, v = A @ A.mT, A @ err
        ((u * du).sum() + (v * dv).sum()).backward()
        grads.append({name: p.raw.grad for name, p in named_params(bank)
                      if p.raw.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1]) == [
        ".kern.stacked.energy", ".kern.stacked.frequency",
        ".kern.stacked.lengthscales", ".kern.stacked.variance"]
    for name, ref in grads[1].items():
        close(grads[0][name], ref.numpy(), 1e-10)


def test_fused_whiten_refuses_wrong_shapes_and_dtypes():
    ts = _t(_inputs(64))
    zc, xc, err, linv, e, f, v, il = ts
    with pytest.raises(ValueError, match="linv"):
        fw.fused_whiten(zc, xc, err, linv[:, :-1], e, f, v, il)
    with pytest.raises(ValueError, match="freq"):
        fw.fused_whiten(zc, xc, err, linv, e, f[:, :-1], v, il)
    with pytest.raises(ValueError, match="zc"):
        fw.fused_whiten(zc[..., 0], xc, err, linv, e, f, v, il)
    with pytest.raises(ValueError, match="err"):
        fw.fused_whiten_plain(zc, xc, err[..., :-1], linv, e, f, v, il)
    with pytest.raises(TypeError, match="inv_l"):
        fw.fused_whiten(zc, xc, err, linv, e, f, v, il.float())
    du, dv = _t(_cotangents())
    with pytest.raises(ValueError, match="dv"):
        fw.fused_whiten_bwd(zc, xc, err, linv, du, dv[:, :-1], e, f, v, il)
    with pytest.raises(ValueError, match="params"):
        fw.fused_whiten_flat(zc, xc, err, linv, torch.zeros(1, 17, dtype=zc.dtype),
                             num_sources=S)


@pytest.mark.parametrize("data", ["zc", "xc", "err"])
def test_fused_whiten_refuses_gradients_in_the_data(data):
    """zc, xc and err get no gradient: both entry points raise when one of
    them requires grad in grad mode, rather than cut it silently, and run
    under no_grad."""
    ts = _t(_inputs(64))
    ts[("zc", "xc", "err").index(data)].requires_grad_(True)
    zc, xc, err, linv, e, f, v, il = ts
    flat = torch.as_tensor(_flat(*_inputs(64)[4:]))
    with pytest.raises(RuntimeError, match="no gradient in zc, xc or err"):
        fw.fused_whiten(*ts)
    with pytest.raises(RuntimeError, match="no gradient in zc, xc or err"):
        fw.fused_whiten_flat(zc, xc, err, linv, flat, num_sources=S)
    with torch.no_grad():
        u, _ = fw.fused_whiten(*ts)
        uf, _ = fw.fused_whiten_flat(zc, xc, err, linv, flat, num_sources=S)
    assert torch.equal(u, uf)


def test_build_window_bank_without_device_never_runs_on_the_cpu():
    """build_window_bank is an entry point: with no ``device`` it targets
    the card, and without one it raises and names device='cpu'."""
    rng = np.random.default_rng(0)
    x = np.arange(201) / FS
    args = (x[None], np.sin(300 * x)[None], np.sort(rng.choice(x, 8))[None, :, None],
            lambda: MercerMatern12sm.create(1.0, 0.1, [1.0], [300.0]))
    if torch.cuda.is_available():
        assert tws.build_window_bank(*args).X.raw.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tws.build_window_bank(*args)
    assert tws.build_window_bank(*args, device="cpu").X.raw.device.type == "cpu"
