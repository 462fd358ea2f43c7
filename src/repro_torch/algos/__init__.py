"""Hand-staged algorithms and their numpy oracles (counterpart of
``repro.algos``).  ``STREAM_STEPS`` maps algorithm names to their
engine-neutral per-batch stream steps (what ``run_stream`` drives)."""
from repro_torch.algos import oracles, pagerank, sssp, triangles

STREAM_STEPS = {
    "sssp": sssp.stream_step,
    "pagerank": pagerank.make_stream_step,   # factory: knobs -> step
    "tc": triangles.stream_step,
}

__all__ = ["oracles", "pagerank", "sssp", "triangles", "STREAM_STEPS"]
