"""launches: CUDA calls a dispatch that enqueue work on the card, counted in the program's spans.

The runtime calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemcpy2DAsync``, ``cudaMemsetAsync``, ``cudaGraphLaunch``) that start inside an
entry span of the program (``benchmark/lib/spans.py``), over the entry spans that start
inside the traced span. Each costs the host a launch: it moves msym_s where the host
sets the pace.
"""
from benchmark.lib import spans


def read(tr):
    return spans.count_per_dispatch(tr, spans.is_launch)
