"""StarPlat-Dynamic DSL frontend (the paper's §3–§4 pipeline; counterpart
of ``repro.core.dsl``).

``compile_source`` runs the full pipeline:

    DSL text ──lexer──▶ tokens ──parser──▶ AST ──semantic──▶ symbol table
        ──analysis──▶ read/write sets + combiner inference
        ──codegen──▶ staged programs against the Engine interface
                      ('torch' | 'cuda' | 'cuda_chained' chosen at run time)

The front half (lexer, parser, AST, analysis, emit) is the reference's
framework-free code, copied; the back half stages the analysed AST into
torch programs executed by any of the port's engines.
"""
from repro_torch.core.dsl.lexer import tokenize, Token, LexError
from repro_torch.core.dsl.parser import parse, ParseError
from repro_torch.core.dsl import ast_nodes as ast
from repro_torch.core.dsl.analysis import analyze, SemanticError, FuncInfo
from repro_torch.core.dsl.codegen import compile_source, Program

__all__ = [
    "tokenize", "Token", "LexError", "parse", "ParseError", "ast",
    "analyze", "SemanticError", "FuncInfo", "compile_source", "Program",
]
