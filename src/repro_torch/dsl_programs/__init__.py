"""The paper's appendix DSL programs (Figs. 19-21), shipped as data
(counterpart of ``repro.dsl_programs``).

Each ``.sp`` file holds the ``static*`` and ``Dyn*`` functions of one
algorithm in the StarPlat-Dynamic appendix syntax; they compile through
``repro_torch.compile`` and run on any of the port's engines.  The files
are byte-identical copies of ``repro``'s (``tests/test_torch_dsl.py``
holds them so), kept here so that the port reads no file of ``repro``.
"""
import pathlib

_HERE = pathlib.Path(__file__).resolve().parent

PROGRAMS = ("sssp", "pagerank", "tc")


def path(name: str) -> str:
    """Absolute path of a shipped program, e.g. ``path('sssp')``."""
    p = _HERE / f"{name}.sp"
    if not p.exists():
        raise KeyError(f"no such DSL program: {name!r} "
                       f"(have {', '.join(PROGRAMS)})")
    return str(p)
