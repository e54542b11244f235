"""syncs: host-blocking CUDA calls a dispatch, counted in the program's spans.

The runtime calls that wait for the card (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, the blocking ``cudaMemcpy``) that
start inside an entry span of the program (``benchmark/lib/spans.py``), over the entry
spans that start inside the traced span. The entries promise none: each would stall the
host until the card drains, and the next dispatch's enqueue behind it.
"""
from benchmark.lib import spans


def read(tr):
    return spans.count_per_dispatch(tr, spans.is_sync)
