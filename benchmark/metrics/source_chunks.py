"""source_chunks: the source chunks that one launch of kernel B walks a
tile at the bank's shapes (its shared memory holds the features of so many
sources at once), from the program's counter
``linalg.fused_whiten.fused_whiten_source_chunks``, set by the plan of the
last launch on the card.  None where the program has no such counter or
launched no kernel B (the CPU runs the plain versions)."""

import importlib


def read(ctx):
    # the module by its path: the package's name ``fused_whiten`` is the function
    module = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
    chunks = getattr(module, "fused_whiten_source_chunks", None)
    return float(chunks.bwd) if chunks is not None and chunks.bwd else None
