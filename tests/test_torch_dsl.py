"""The port's DSL front end against repro's: the shipped ``.sp`` programs
are byte-identical copies, and the lexer, parser, analysis and lowering
report of ``repro_torch.core.dsl`` give what ``repro.core.dsl`` gives on
each of them (the report's backend table aside)."""
import dataclasses
import pathlib

import pytest

from repro import dsl_programs as r_programs
from repro.core import dsl as r_dsl
from repro.core.dsl import emit as r_emit
from repro_torch import dsl_programs as t_programs
from repro_torch.core import dsl as t_dsl
from repro_torch.core.dsl import emit as t_emit

PROGRAMS = ["sssp", "pagerank", "tc"]


def plain(obj):
    """A dataclass tree as nested (class name, fields) tuples, so that
    the two packages' node classes compare by content."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(x) for x in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return frozenset(plain(x) for x in obj)
    return obj


def test_programs_are_the_reference_files():
    assert t_programs.PROGRAMS == r_programs.PROGRAMS == tuple(PROGRAMS)
    here = pathlib.Path(t_programs.path("sssp")).parent
    assert sorted(p.name for p in here.glob("*.sp")) == \
        sorted(f"{name}.sp" for name in PROGRAMS)
    with pytest.raises(KeyError):
        t_programs.path("bfs")


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_bytes(name):
    assert pathlib.Path(t_programs.path(name)).read_bytes() == \
        pathlib.Path(r_programs.path(name)).read_bytes()
    assert t_programs.path(name) != r_programs.path(name)


@pytest.mark.parametrize("name", PROGRAMS)
def test_front_end_matches(name):
    src = pathlib.Path(r_programs.path(name)).read_text()
    assert plain(t_dsl.tokenize(src)) == plain(r_dsl.tokenize(src))
    t_ast, r_ast = t_dsl.parse(src), r_dsl.parse(src)
    assert plain(t_ast) == plain(r_ast)
    assert plain(t_dsl.analyze(t_ast)) == plain(r_dsl.analyze(r_ast))


@pytest.mark.parametrize("name", PROGRAMS)
def test_report_differs_only_in_the_backend_table(name):
    src = pathlib.Path(r_programs.path(name)).read_text()
    t_prog = t_dsl.compile_source(src)
    r_prog = r_dsl.compile_source(src)
    for backend, ref_backend in (("torch", "jnp"), ("cuda", "pallas"),
                                 ("cuda_chained", "pallas")):
        got = t_emit.emit_report(t_prog, backend).splitlines()
        want = r_emit.emit_report(r_prog, ref_backend).splitlines()
        assert got[0] == f"== StarPlat-Dynamic lowering report " \
                         f"(backend={backend}) =="
        assert got[1] == "synchronization: " + t_emit._BACKEND_SYNC[backend]
        assert got[2:] == want[2:]
    assert t_emit.emit_report(t_prog) == t_emit.emit_report(t_prog, "torch")


BAD_PROGRAMS = [
    ("Static f(Graph g) { int x = 3 @ 4; }", "LexError"),
    ("Static f(Graph g) { forall (v in ) { } }", "ParseError"),
    ("Static f(Graph g, propNode<int> dist) {\n"
     "  forall (v in g.nodes()) { v.distt = 0; } }", "SemanticError"),
    ("Static f(Graph g) { int x; int y = x + 1; }", "SemanticError"),
]


@pytest.mark.parametrize("src,err", BAD_PROGRAMS,
                         ids=["lex", "parse", "undeclared-prop",
                              "read-before-write"])
def test_front_end_errors_match(src, err):
    """A program the front end rejects is rejected the same way."""
    with pytest.raises(getattr(r_dsl, err)) as r_err:
        r_dsl.analyze(r_dsl.parse(src))
    with pytest.raises(getattr(t_dsl, err)) as t_err:
        t_dsl.analyze(t_dsl.parse(src))
    assert str(t_err.value) == str(r_err.value)
