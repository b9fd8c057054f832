"""Plotting utilities.

A copy of gpitch_tpu/viz/plots.py: GP posterior bands, latent and
squashed activation views with inducing marks, FFT panels, pianoroll
images.  Every function takes tensors (on any device) or arrays.
matplotlib is imported inside ``_plt()``, never when the package is
imported, so a process that draws nothing does not need it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plotgp", "plot_predict", "plot_fft", "plot_pianoroll",
           "plot_sources", "plot_kernel_fit", "plot_pdgp", "plot_zoom_in",
           "plot_data", "plot_predict_all", "plot_sources_all",
           "plot_training_all", "plot_trained_models", "plot_parameters",
           "plot_patches", "plot_fft_all"]


def _np(a) -> np.ndarray:
    """A tensor (detached, on the host) or anything array-like as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    if isinstance(a, (list, tuple)) and any(isinstance(v, torch.Tensor) for v in a):
        return np.asarray([_np(v) for v in a])
    return np.asarray(a)


def _logistic(x) -> np.ndarray:
    """``utils.math.logistic`` on the host: 1 / (1 + exp(-2 (x - pi)))."""
    return 0.5 * (np.tanh(_np(x) - np.pi) + 1.0)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plotgp(x, y, xnew, mean, variance, ax=None):
    """Data + posterior mean with a 2-sigma band (myplots.py:47-57)."""
    plt = _plt()
    ax = ax or plt.gca()
    xnew = _np(xnew).reshape(-1)
    mean = _np(mean).reshape(-1)
    sd = 2.0 * np.sqrt(np.maximum(_np(variance).reshape(-1), 0.0))
    if x is not None:
        ax.plot(_np(x).reshape(-1), _np(y).reshape(-1), "k.", ms=2)
    ax.plot(xnew, mean, "C0", lw=1.5)
    ax.fill_between(xnew, mean - sd, mean + sd, color="C0", alpha=0.2)
    return ax


def plot_predict(x, mean, var, z=None, latent=False, ax=None):
    """Posterior of an activation/component GP, optionally squashed through the
    model nonlinearity, with inducing-point marks (myplots.py:60-79)."""
    plt = _plt()
    ax = ax or plt.gca()
    x = _np(x).reshape(-1)
    mean = _np(mean).reshape(-1)
    sd = 2.0 * np.sqrt(np.maximum(_np(var).reshape(-1), 0.0))
    if latent:
        lo, mid, hi = mean - sd, mean, mean + sd
    else:
        lo, mid, hi = (_np(_logistic(v)) for v in (mean - sd, mean, mean + sd))
    ax.plot(x, mid, "C0", lw=1.5)
    ax.fill_between(x, lo, hi, color="C0", alpha=0.2)
    if z is not None:
        z = _np(z).reshape(-1)
        ax.plot(z, np.full_like(z, float(np.min(lo))), "C1|", ms=10)
    return ax


def plot_fft(F, S, peaks=None, ax=None):
    """Spectral density with detected peaks (myplots.py:201-214)."""
    plt = _plt()
    ax = ax or plt.gca()
    ax.plot(_np(F), _np(S), "C0", lw=0.8)
    if peaks is not None:
        freqs, energies = peaks
        ax.plot(freqs, energies, "C3x", ms=8)
    ax.set_xlabel("frequency (Hz)")
    return ax


def plot_pianoroll(matrix, fs=20.0, ax=None):
    """88 x T binary roll image (transcription.py:124-126 usage)."""
    plt = _plt()
    ax = ax or plt.gca()
    ax.imshow(_np(matrix), cmap="binary", aspect="auto",
              extent=[0, _np(matrix).shape[1] / fs, 21, 109])
    ax.set_xlabel("time (s)")
    ax.set_ylabel("MIDI pitch")
    return ax


def plot_sources(x, y, sources, fig=None):
    """Mixture vs per-source estimates, one row each (window_overlap.py:140-154)."""
    plt = _plt()
    n = len(sources)
    fig = fig or plt.figure(figsize=(12, 2.5 * n))
    for i, s in enumerate(sources):
        ax = fig.add_subplot(n, 1, i + 1)
        ax.plot(_np(x).reshape(-1), _np(y).reshape(-1), "C0", lw=0.5)
        ax.plot(_np(x).reshape(-1), _np(s).reshape(-1), "C1", lw=0.8)
        ax.set_ylim(-1, 1)
    return fig


def plot_kernel_fit(xkern, sampled, fitted, ax=None):
    """Sampled vs fitted kernel (separation.py:134-160)."""
    plt = _plt()
    ax = ax or plt.gca()
    ax.plot(_np(xkern).reshape(-1), _np(sampled).reshape(-1), "C0")
    ax.plot(_np(xkern).reshape(-1), _np(fitted).reshape(-1), "C1")
    ax.legend(["sampled kernel", "approx kernel"])
    return ax


def plot_zoom_in(x_src, y_src, xnew, mean, variance,
                 limits=(8.10, 8.107, -0.47, 0.32), loc=3, size=("30%", "30%"),
                 fig=None):
    """Separation result with an inset zoom on a short segment
    (myplots.py:8-44): full-length true source + GP estimate band, plus a
    magnified copy framed by inset marks."""
    plt = _plt()
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes, mark_inset
    fig = fig or plt.figure(figsize=(16, 4))
    ax = fig.add_subplot(1, 1, 1)
    plotgp(x_src, y_src, xnew, mean, variance, ax=ax)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.legend(["True source", "GP estimate", "Uncertainty"])
    inset = inset_axes(ax, width=size[0], height=size[1], loc=loc,
                       bbox_to_anchor=(0.5, 0, 1, 1), bbox_transform=ax.transAxes)
    plotgp(x_src, y_src, xnew, mean, variance, ax=inset)
    x1, x2, y1, y2 = limits
    inset.set_xlim(x1, x2)
    inset.set_ylim(y1, y2)
    inset.set_xticks([])
    inset.set_yticks([])
    mark_inset(ax, inset, loc1=2, loc2=4, fc="none", ec="0.5")
    return fig


def _grid(num_sources, maxncol):
    """(nrow, ncol) layout used by the evaluation grids (myplots.py:83-99)."""
    if num_sources == 0:
        return 1, 1
    ncol = min(num_sources, maxncol)
    return 2 + (num_sources - 1) // maxncol, ncol


def plot_data(x, y, sources=None, maxncol=4, fig=None):
    """Mixture on a full-width top row, each true source below
    (myplots.py:83-112)."""
    plt = _plt()
    sources = sources or []
    nrow, ncol = _grid(len(sources), maxncol)
    fig = fig or plt.figure(figsize=(16, 4 * nrow))
    x = _np(x).reshape(-1)
    ax = fig.add_subplot(nrow, 1, 1)
    ax.plot(x, _np(y).reshape(-1))
    ax.set_xlim(x[0], x[-1])
    ax.legend(["Data"], loc=1)
    for i, s in enumerate(sources):
        ax = fig.add_subplot(nrow, ncol, i + 1 + ncol)
        ax.plot(x, _np(s).reshape(-1))
        ax.set_xlim(x[0], x[-1])
        ax.legend([f"Source {i + 1}"], loc=1)
    return fig


def plot_predict_all(x, mean_act, var_act, mean_com, var_com, z=None,
                     maxncol=4, fig=None):
    """Activation (sigmoid view) and component posteriors for every source,
    two rows per source block (myplots.py:115-125).

    mean/var arrays: (N, S); z: optional (za (S,Ma,1), zc (S,Mc,1))."""
    plt = _plt()
    mean_act, var_act = _np(mean_act), _np(var_act)
    mean_com, var_com = _np(mean_com), _np(var_com)
    s = mean_act.shape[1]
    ncol = min(s, maxncol)
    nblocks = -(-s // ncol)
    nrow = 2 * nblocks
    fig = fig or plt.figure(figsize=(16, 4 * nrow))
    for i in range(s):
        blk, col = divmod(i, ncol)
        ax = fig.add_subplot(nrow, ncol, 2 * blk * ncol + col + 1)
        plot_predict(x, mean_act[:, i], var_act[:, i],
                     z=None if z is None else z[0][i], latent=False, ax=ax)
        ax.set_title(f"activation {i + 1}")
        ax = fig.add_subplot(nrow, ncol, (2 * blk + 1) * ncol + col + 1)
        plot_predict(x, mean_com[:, i], var_com[:, i],
                     z=None if z is None else z[1][i], latent=True, ax=ax)
        ax.set_title(f"component {i + 1}")
    return fig


def plot_sources_all(x, y, esources, sources=None, maxncol=4, fig=None):
    """Data + summed prediction on top, per-source estimate (vs truth when
    given) below (myplots.py:128-165)."""
    plt = _plt()
    esources = [_np(e).reshape(-1) for e in esources]
    nrow, ncol = _grid(len(esources), maxncol)
    fig = fig or plt.figure(figsize=(16, 4 * nrow))
    x = _np(x).reshape(-1)
    ax = fig.add_subplot(nrow, 1, 1)
    ax.plot(x, _np(y).reshape(-1), "xk", ms=3)
    ax.plot(x, np.sum(esources, axis=0) if esources else np.zeros_like(x), lw=2)
    ax.set_ylim(-1.1, 1.1)
    ax.legend(["Data", "Prediction"], loc=1)
    for i, e in enumerate(esources):
        ax = fig.add_subplot(nrow, ncol, i + 1 + ncol)
        if sources is not None:
            ax.plot(x, _np(sources[i]).reshape(-1), "xk", ms=3)
        ax.plot(x, e, lw=2)
        ax.set_ylim(-1.1, 1.1)
    return fig


def plot_training_all(x, y, source, m_a, v_a, m_c, v_c, z=None, fig=None):
    """4-panel single-pitch training summary: data, approximation, activation,
    component (myplots.py:170-183)."""
    plt = _plt()
    fig = fig or plt.figure(figsize=(16, 3))
    x = _np(x).reshape(-1)
    ax = fig.add_subplot(1, 4, 1)
    ax.plot(x, _np(y).reshape(-1))
    ax.set_ylim(-1.1, 1.1)
    ax.set_title("data")
    ax = fig.add_subplot(1, 4, 2)
    ax.plot(x, _np(source).reshape(-1))
    ax.set_ylim(-1.1, 1.1)
    ax.set_title("approximation")
    ax = fig.add_subplot(1, 4, 3)
    plot_predict(x, m_a, v_a, z=None if z is None else z[0], latent=False, ax=ax)
    ax.set_title("activation")
    ax = fig.add_subplot(1, 4, 4)
    plot_predict(x, m_c, v_c, z=None if z is None else z[1], latent=True, ax=ax)
    ax.set_title("component")
    return fig


def plot_trained_models(models, data, predictions, instr_name="", nlinfun=None):
    """One training summary row per trained single-pitch model
    (myplots.py:186-198).

    models: list of ModGP; data: list of (x, y); predictions: list of
    (m_a, v_a, m_c, v_c) from predict_act_n_com."""
    nlinfun = nlinfun or _logistic   # any other nlinfun gets a tensor
    figs = []
    for m, (x, y), pred in zip(models, data, predictions):
        m_a, v_a, m_c, v_c = (_np(p)[:, 0] for p in pred[:4])
        source = _np(nlinfun(m_a if nlinfun is _logistic else torch.as_tensor(m_a))) * m_c
        figs.append(plot_training_all(
            x, y, source, m_a, v_a, m_c, v_c,
            z=(_np(m.za.value)[0], _np(m.zc.value)[0])))
    if figs and instr_name:
        figs[-1].suptitle(instr_name)
    return figs


def plot_parameters(models, fig=None):
    """Scatter of learned hyperparameters across a list of trained models:
    activation lengthscale/variance, component lengthscale/f0, noise variance
    (myplots.py:217-243)."""
    plt = _plt()
    fig = fig or plt.figure(figsize=(16, 4))
    titles = ["lengthscale activation", "variance activation",
              "lengthscale component", "f0 component", "noise variance"]

    def _scalar(a):
        return float(_np(a).reshape(-1)[0])

    getters = [
        lambda m: _scalar(m.kern_act.lengthscales.value),
        lambda m: _scalar(m.kern_act.variance.value),
        lambda m: _scalar(m.kern_com.lengthscales.value),
        lambda m: _scalar(m.kern_com.frequency.value),
        lambda m: _scalar(m.likelihood.variance.value),
    ]
    for j, (title, get) in enumerate(zip(titles, getters)):
        ax = fig.add_subplot(1, 5, j + 1)
        ax.set_title(title)
        ax.grid(True)
        for i, m in enumerate(models):
            try:
                ax.plot(i, get(m), ".C1")
            except AttributeError:
                continue
        ax.set_xlim(-1, max(len(models), 12))
    return fig


def plot_patches(x_windows, y_windows, source_windows, fig=None):
    """Per-window source estimates stacked with vertical offsets, one figure
    per source (window_overlap.py:157-172)."""
    plt = _plt()
    ns = len(source_windows)
    fig = fig or plt.figure(figsize=(16, 4 * ns))
    for si in range(ns):
        ax = fig.add_subplot(ns, 1, si + 1)
        for i, (xw, yw) in enumerate(zip(x_windows, y_windows)):
            xw = _np(xw).reshape(-1)
            ax.plot(xw, i + _np(source_windows[si][i]).reshape(-1), "C0",
                    lw=0.6)
            ax.plot(xw, i + _np(yw).reshape(-1), "C1", lw=0.6)
        ax.set_title(f"source {si + 1} windows")
    return fig


def plot_fft_all(F1, F2, y_list, yk_list, iparam, maxfreq=4000.0, fig=None):
    """FFT of each training file vs its sampled-kernel FFT, with the picked
    (frequency, energy) features marked (myplots.py:201-214)."""
    plt = _plt()
    n = len(y_list)
    ncol = 3
    nrow = -(-n // ncol)
    fig = fig or plt.figure(figsize=(16, 4 * nrow))
    for i in range(n):
        y1 = np.abs(np.fft.fft(_np(y_list[i]).reshape(-1)))
        y1 = y1[: y1.size // 2]
        y2 = np.abs(np.fft.fft(_np(yk_list[i]).reshape(-1)))
        y2 = y2[: y2.size // 2]
        y1, y2 = y1 / max(np.max(y1), 1e-30), y2 / max(np.max(y2), 1e-30)
        ax = fig.add_subplot(nrow, ncol, i + 1)
        ax.plot(_np(F1).reshape(-1)[: y1.size], y1, "C0", lw=0.6)
        ax.plot(_np(F2).reshape(-1)[: y2.size], y2, "C1", lw=0.6)
        ax2 = ax.twinx()
        freqs, energies = _np(iparam[i][0]), _np(iparam[i][1])
        ax2.plot(freqs, energies / max(np.max(energies), 1e-30), "|C4", mew=2)
        ax.set_xlim(0, maxfreq)
    return fig


def plot_pdgp(x, y, xtest, results, z=None, fig=None):
    """3-panel modulated-GP summary: source, activation, component
    (myplots.py:247-265, demos/scripts/demo-modgp.py:52-71)."""
    plt = _plt()
    mean_a, var_a, mean_c, var_c, mean_s = results
    fig = fig or plt.figure(figsize=(12, 8))
    ax1 = fig.add_subplot(3, 1, 1)
    ax1.plot(_np(x).reshape(-1), _np(y).reshape(-1), "k--", lw=0.5)
    ax1.plot(_np(xtest).reshape(-1), _np(mean_s)[:, 0], lw=2)
    ax1.legend(["data", "prediction"])
    ax2 = fig.add_subplot(3, 1, 2)
    plot_predict(xtest, _np(mean_a)[:, 0], _np(var_a)[:, 0],
                 z=None if z is None else z[0], latent=True, ax=ax2)
    ax2.set_title("activation (latent)")
    ax3 = fig.add_subplot(3, 1, 3)
    plot_predict(xtest, _np(mean_c)[:, 0], _np(var_c)[:, 0],
                 z=None if z is None else z[1], latent=True, ax=ax3)
    ax3.set_title("component")
    return fig
