from .mesh import (init_multihost, make_bank_loss_shard_map, make_mesh,  # noqa: F401
                   pad_bank_windows, replicate, shard_bank, shard_leading_axis,
                   shard_modgp_sources)

__all__ = ["make_mesh", "shard_leading_axis", "replicate", "pad_bank_windows",
           "shard_bank", "shard_modgp_sources", "init_multihost",
           "make_bank_loss_shard_map"]
