"""Recursive-descent parser: tokens → AST (paper front-end, §4.1).

The grammar covers the full appendix programs (Figs. 19–21):

  program     := funcdef*
  funcdef     := kind IDENT? '(' params ')' block
  kind        := 'Static' | 'Dynamic' | 'Incremental' | 'Decremental'
  type        := prim | ('propNode'|'propEdge') '<' prim '>'
               | 'updates' '<' IDENT '>'
  stmt        := decl | assign | multiassign | if | while | dowhile
               | forall | fixedPoint | Batch | OnAdd | OnDelete
               | call ';' | return
  forall      := ('forall'|'for') '(' IDENT 'in' postfix
                 ['.' 'filter' '(' expr ')'] ')' block
  fixedPoint  := 'fixedPoint' 'until' '(' IDENT ':' expr ')' block
  multiassign := '<' lval,+ '>' '=' '<' expr,+ '>' ';'

Expressions use C precedence (|| < && < ==/!= < rel < +- < */% < unary
< postfix).  ``Min``/``Max`` parse as dedicated nodes since they carry
the paper's atomic multi-assignment semantics.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.dsl import ast_nodes as A
from repro_torch.core.dsl.lexer import Token, tokenize

_PRIM_TYPES = {"int", "long", "float", "double", "bool", "node", "edge",
               "Graph"}
_FUNC_KINDS = {"Static", "Dynamic", "Incremental", "Decremental"}


class ParseError(SyntaxError):
    pass


class Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.i = 0

    # -- token helpers -------------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, k: int = 1) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def at(self, kind: str, text: Optional[str] = None) -> bool:
        return self.cur.kind == kind and (text is None or self.cur.text == text)

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        if self.at(kind, text):
            return self.advance()
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        if not self.at(kind, text):
            raise ParseError(
                f"line {self.cur.line}: expected "
                f"{text or kind}, got {self.cur.text!r}")
        return self.advance()

    # -- program / functions ---------------------------------------------------
    def parse_program(self) -> A.ProgramAST:
        funcs = []
        while not self.at("eof"):
            funcs.append(self.parse_funcdef())
        return A.ProgramAST(funcs=funcs, line=1)

    def parse_funcdef(self) -> A.FuncDef:
        t = self.cur
        if not (t.kind == "kw" and t.text in _FUNC_KINDS):
            raise ParseError(f"line {t.line}: expected function kind, "
                             f"got {t.text!r}")
        kind = self.advance().text
        name = kind
        if self.at("ident"):
            name = self.advance().text
        self.expect("op", "(")
        params = []
        if not self.at("op", ")"):
            params.append(self.parse_param())
            while self.accept("op", ","):
                params.append(self.parse_param())
        self.expect("op", ")")
        body = self.parse_block()
        return A.FuncDef(kind=kind, name=name, params=params, body=body,
                         line=t.line)

    def parse_param(self) -> A.Param:
        ty = self.parse_type()
        name = self.expect("ident").text
        return A.Param(type=ty, name=name, line=self.cur.line)

    def parse_type(self) -> A.Type:
        t = self.cur
        if t.kind == "kw" and t.text in ("propNode", "propEdge"):
            self.advance()
            self.expect("op", "<")
            inner = self.expect("kw").text
            if inner not in _PRIM_TYPES:
                raise ParseError(f"line {t.line}: bad prop type {inner}")
            self.expect("op", ">")
            return A.Type(name=t.text, arg=inner, line=t.line)
        if t.kind == "kw" and t.text == "updates":
            self.advance()
            self.expect("op", "<")
            g = self.expect("ident").text
            self.expect("op", ">")
            return A.Type(name="updates", arg=g, line=t.line)
        if t.kind == "kw" and t.text in _PRIM_TYPES:
            self.advance()
            return A.Type(name=t.text, line=t.line)
        raise ParseError(f"line {t.line}: expected type, got {t.text!r}")

    # -- statements -----------------------------------------------------------
    def parse_block(self) -> A.Block:
        t = self.expect("op", "{")
        stmts = []
        while not self.at("op", "}"):
            stmts.append(self.parse_stmt())
        self.expect("op", "}")
        return A.Block(stmts=stmts, line=t.line)

    def parse_block_or_stmt(self) -> A.Block:
        if self.at("op", "{"):
            return self.parse_block()
        s = self.parse_stmt()
        return A.Block(stmts=[s], line=s.line)

    def parse_stmt(self) -> A.Stmt:
        t = self.cur
        if t.kind == "kw":
            if t.text in _PRIM_TYPES or t.text in ("propNode", "propEdge",
                                                   "updates"):
                return self.parse_decl()
            if t.text == "if":
                return self.parse_if()
            if t.text == "while":
                return self.parse_while()
            if t.text == "do":
                return self.parse_dowhile()
            if t.text in ("forall", "for"):
                return self.parse_forall()
            if t.text == "fixedPoint":
                return self.parse_fixedpoint()
            if t.text == "Batch":
                return self.parse_batch()
            if t.text in ("OnAdd", "OnDelete"):
                return self.parse_onupdate()
            if t.text == "return":
                self.advance()
                v = self.parse_expr()
                self.expect("op", ";")
                return A.Return(value=v, line=t.line)
        if t.kind == "op" and t.text == "<":
            return self.parse_multiassign()
        # expression statement: assignment or call
        e = self.parse_expr()
        if self.at("op") and self.cur.text in ("=", "+=", "-="):
            op = self.advance().text
            v = self.parse_expr()
            self.expect("op", ";")
            if not isinstance(e, (A.Name, A.Attr)):
                raise ParseError(f"line {t.line}: bad assignment target")
            return A.Assign(target=e, op=op, value=v, line=t.line)
        self.expect("op", ";")
        if isinstance(e, A.Call):
            return A.CallStmt(call=e, line=t.line)
        raise ParseError(f"line {t.line}: expression has no effect")

    def parse_decl(self) -> A.Decl:
        t = self.cur
        ty = self.parse_type()
        name = self.expect("ident").text
        init = None
        if self.accept("op", "="):
            init = self.parse_expr()
        self.expect("op", ";")
        return A.Decl(type=ty, name=name, init=init, line=t.line)

    def parse_if(self) -> A.If:
        t = self.expect("kw", "if")
        self.expect("op", "(")
        cond = self.parse_expr()
        self.expect("op", ")")
        then = self.parse_block_or_stmt()
        orelse = None
        if self.accept("kw", "else"):
            orelse = self.parse_block_or_stmt()
        return A.If(cond=cond, then=then, orelse=orelse, line=t.line)

    def parse_while(self) -> A.While:
        t = self.expect("kw", "while")
        self.expect("op", "(")
        cond = self.parse_expr()
        self.expect("op", ")")
        body = self.parse_block()
        return A.While(cond=cond, body=body, line=t.line)

    def parse_dowhile(self) -> A.DoWhile:
        t = self.expect("kw", "do")
        body = self.parse_block()
        self.expect("kw", "while")
        self.expect("op", "(")
        cond = self.parse_expr()
        self.expect("op", ")")
        self.expect("op", ";")
        return A.DoWhile(body=body, cond=cond, line=t.line)

    def parse_forall(self) -> A.ForAll:
        t = self.advance()               # 'forall' | 'for'
        parallel = t.text == "forall"
        self.expect("op", "(")
        var = self.expect("ident").text
        self.expect("kw", "in")
        it = self.parse_postfix()
        # iterator-level filter: g.nodes().filter(cond) parses into the
        # postfix chain; pull it off so codegen sees iter + filter apart.
        filt = None
        if isinstance(it, A.Call) and isinstance(it.func, A.Attr) \
                and it.func.name == "filter":
            filt = it.args[0] if it.args else None
            it = it.func.obj
        self.expect("op", ")")
        # optional ':' before block (paper Fig. 21 writes `):{`)
        self.accept("op", ":")
        body = self.parse_block()
        return A.ForAll(var=var, iter=it, filter=filt, body=body,
                        parallel=parallel, line=t.line)

    def parse_fixedpoint(self) -> A.FixedPoint:
        t = self.expect("kw", "fixedPoint")
        self.expect("kw", "until")
        self.expect("op", "(")
        flag = self.expect("ident").text
        self.expect("op", ":")
        cond = self.parse_expr()
        self.expect("op", ")")
        body = self.parse_block()
        return A.FixedPoint(flag=flag, cond=cond, body=body, line=t.line)

    def parse_batch(self) -> A.BatchStmt:
        t = self.expect("kw", "Batch")
        self.expect("op", "(")
        ups = self.expect("ident").text
        self.expect("op", ":")
        bs = self.expect("ident").text
        self.expect("op", ")")
        body = self.parse_block()
        return A.BatchStmt(updates=ups, batch_size=bs, body=body, line=t.line)

    def parse_onupdate(self) -> A.OnUpdate:
        t = self.advance()
        kind = "add" if t.text == "OnAdd" else "delete"
        self.expect("op", "(")
        var = self.expect("ident").text
        self.expect("kw", "in")
        src = self.parse_postfix()
        self.expect("op", ")")
        self.accept("op", ":")
        body = self.parse_block()
        return A.OnUpdate(kind=kind, var=var, source=src, body=body,
                          line=t.line)

    def parse_multiassign(self) -> A.MultiAssign:
        t = self.expect("op", "<")
        targets = [self.parse_postfix()]
        while self.accept("op", ","):
            targets.append(self.parse_postfix())
        self.expect("op", ">")
        self.expect("op", "=")
        self.expect("op", "<")
        # values parse at additive precedence so the closing '>' is not
        # mistaken for a relation (Min(...) args are full exprs in parens)
        values = [self.parse_add()]
        while self.accept("op", ","):
            values.append(self.parse_add())
        self.expect("op", ">")
        self.expect("op", ";")
        if len(targets) != len(values):
            raise ParseError(f"line {t.line}: multi-assignment arity "
                             f"mismatch")
        return A.MultiAssign(targets=targets, values=values, line=t.line)

    # -- expressions -----------------------------------------------------------
    def parse_expr(self) -> A.Expr:
        return self.parse_or()

    def _binop(self, sub, ops):
        e = sub()
        while self.cur.kind == "op" and self.cur.text in ops:
            op = self.advance().text
            rhs = sub()
            e = A.Binary(op=op, left=e, right=rhs, line=e.line)
        return e

    def parse_or(self):
        return self._binop(self.parse_and, ("||",))

    def parse_and(self):
        return self._binop(self.parse_eq, ("&&",))

    def parse_eq(self):
        return self._binop(self.parse_rel, ("==", "!="))

    def parse_rel(self):
        # NB: '<'/'>' only appear as relations inside parenthesized
        # expression context; multi-assign '<' is handled at stmt level.
        return self._binop(self.parse_add, ("<", ">", "<=", ">="))

    def parse_add(self):
        return self._binop(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._binop(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        t = self.cur
        if t.kind == "op" and t.text in ("!", "-"):
            self.advance()
            return A.Unary(op=t.text, operand=self.parse_unary(), line=t.line)
        return self.parse_postfix()

    def parse_args(self) -> list:
        """'(' already consumed; parses positional and ``name = expr``
        keyword arguments (paper: g.attachNodeProperty(dist=INF, ...))."""
        args = []
        if not self.at("op", ")"):
            args.append(self.parse_arg())
            while self.accept("op", ","):
                args.append(self.parse_arg())
        self.expect("op", ")")
        return args

    def parse_arg(self) -> A.Expr:
        if self.at("ident") and self.peek().kind == "op" \
                and self.peek().text == "=":
            name = self.advance().text
            self.advance()             # '='
            return A.Kwarg(name=name, value=self.parse_expr(),
                           line=self.cur.line)
        return self.parse_expr()

    def parse_postfix(self) -> A.Expr:
        e = self.parse_primary()
        while True:
            if self.accept("op", "."):
                name = self.advance()
                if name.kind not in ("ident", "kw"):
                    raise ParseError(f"line {name.line}: bad attribute")
                if self.at("op", "("):
                    self.advance()
                    args = self.parse_args()
                    e = A.Call(func=A.Attr(obj=e, name=name.text,
                                           line=name.line),
                               args=args, line=name.line)
                else:
                    e = A.Attr(obj=e, name=name.text, line=name.line)
            elif self.at("op", "(") and isinstance(e, A.Name):
                self.advance()
                args = self.parse_args()
                e = A.Call(func=e, args=args, line=e.line)
            else:
                return e

    def parse_primary(self) -> A.Expr:
        t = self.cur
        if t.kind == "num":
            self.advance()
            isf = "." in t.text
            return A.Num(value=float(t.text) if isf else int(t.text),
                         is_float=isf, line=t.line)
        if t.kind == "kw" and t.text in ("True", "False"):
            self.advance()
            return A.Bool(value=t.text == "True", line=t.line)
        if t.kind == "kw" and t.text == "INF":
            self.advance()
            return A.Inf(line=t.line)
        if t.kind == "kw" and t.text in ("Min", "Max"):
            self.advance()
            self.expect("op", "(")
            args = [self.parse_expr()]
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            return A.MinMax(op=t.text, args=args, line=t.line)
        if t.kind == "ident":
            self.advance()
            return A.Name(ident=t.text, line=t.line)
        if t.kind == "kw" and t.text in _FUNC_KINDS:
            # calls to the special Incremental/Decremental functions
            self.advance()
            return A.Name(ident=t.text, line=t.line)
        if t.kind == "op" and t.text == "(":
            self.advance()
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        raise ParseError(f"line {t.line}: unexpected token {t.text!r}")


def parse(src: str) -> A.ProgramAST:
    return Parser(tokenize(src)).parse_program()
