"""Flat-code circuit parser.

Copy of ``go_snark_study_tpu/circuitcompiler/parser.py`` (reference:
circuitcompiler/parser.go).  Produces the ``main`` Circuit with the
reference's exact signal ordering and constraint stream:

  * ``main``'s signal list starts with "one"; one ``in`` constraint is
    appended per public input then per private input (parser.go:218-259).
  * ``equals(a, b)`` expands into TWO mirrored ``*`` constraints
    (parser.go:264-282).
  * function calls are inlined at parse time with per-call unique renaming —
    every identifier in the callee body gets the call counter appended unless
    the rename map binds it to a caller signal (parser.go:287-317).  Quirk
    preserved: numeric literals inside callee bodies are suffixed too (a
    latent reference bug that only bites funcs with constants in their body).
  * ``import "path"`` parses the imported file and — mirroring the
    reference's package-global map reset (parser.go:208-213, 319-327) —
    REPLACES the current function table with the imported one, so imports
    must precede ``func main`` (they do in all reference corpora).
  * unlike the reference we never ``os.Exit``/panic mid-library: all failures
    raise ``ParseError`` (SURVEY quirks table: "Replace with errors").
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

from .circuit import Circuit, Constraint, _is_value
from .lexer import Scanner, TOK_EOF

__all__ = ["Parser", "ParseError", "parse_source", "parse_file"]

_PARENS = re.compile(r"\((.*?)\)")


class ParseError(Exception):
    pass


def _clean(s: str) -> str:
    return s.replace(" ", "").replace("\t", "")


class Parser:
    """One parse pass over one source text.  Unlike the reference's
    package-global ``circuits`` map, state is per-parser (re-entrant)."""

    def __init__(self, text: str, base_dir: Optional[str] = None):
        self.s = Scanner(text)
        self.base_dir = base_dir
        self.circuits: Dict[str, Circuit] = {}

    # ------------------------------------------------------------------
    def _parse_line(self) -> Optional[Constraint]:
        c = Constraint()
        kind, lit = self.s.scan_ignore_ws()
        if kind == TOK_EOF:
            return None
        c.out = lit
        c.literal = lit

        if c.literal == "func":
            # `func name(private a, public b):`
            line = self.s.read_until(":")
            fname = _clean(line.split("(")[0])
            c.v1 = fname
            m = _PARENS.search(line)
            if not m:
                raise ParseError(f"malformed func header: {line!r}")
            for inp in _clean(m.group(1)).split(","):
                if "private" in inp:
                    c.private_inputs.append(inp.replace("private", ""))
                elif "public" in inp:
                    c.public_inputs.append(inp.replace("public", ""))
                else:
                    raise ParseError(
                        "error on declaration of public and private inputs: "
                        f"{inp!r}"
                    )
            return c

        if c.literal == "equals":
            line = self.s.read_until(")")
            m = _PARENS.search(line)
            if not m:
                raise ParseError(f"malformed equals: {line!r}")
            params = _clean(m.group(1)).split(",")
            c.v1, c.v2 = params[0], params[1]
            return c

        if c.literal == "return":
            _, var_to_return = self.s.scan_ignore_ws()
            c.out = var_to_return
            return c

        if c.literal == "import":
            line = self.s.read_until("\n")
            path = line.replace('"', "").replace(" ", "").replace("\n", "")
            c.out = path
            return c

        # assignment: `out = v1 op v2`  or call: `out = fname(args)`
        _, lit = self.s.scan_ignore_ws()  # '='
        c.literal += lit
        _, lit = self.s.scan_ignore_ws()
        if lit in self.circuits:
            c.literal = "call"
            c.op = lit  # function name
            line = self.s.read_until(")")
            m = _PARENS.search(line)
            if not m:
                raise ParseError(f"malformed call: {line!r}")
            c.private_inputs = _clean(m.group(1)).split(",")
            return c
        c.v1 = lit
        c.literal += lit
        _, lit = self.s.scan_ignore_ws()
        if lit == "(":
            raise ParseError("using not declared function")
        c.op = lit
        c.literal += lit
        _, lit = self.s.scan_ignore_ws()
        c.v2 = lit
        c.literal += lit
        return c

    # ------------------------------------------------------------------
    def parse(self) -> Circuit:
        self.circuits = {"main": Circuit()}
        self.circuits["main"].signals.append("one")
        main_exist = False
        calls_count = 0
        curr = ""

        while True:
            try:
                cons = self._parse_line()
            except ParseError:
                raise
            if cons is None:
                break

            if cons.literal == "func":
                if cons.v1 != "main":
                    curr = cons.v1
                    self.circuits[curr] = Circuit()
                    self.circuits[curr].constraints.append(cons)
                    continue
                curr = "main"
                main_exist = True
                mc = self.circuits["main"]
                for inp in cons.public_inputs:
                    mc.constraints.append(Constraint(op="in", out=inp))
                    _add_signal(mc, inp)
                    mc.n_public += 1
                for inp in cons.private_inputs:
                    mc.constraints.append(Constraint(op="in", out=inp))
                    _add_signal(mc, inp)
                mc.public_inputs = list(cons.public_inputs)
                mc.private_inputs = list(cons.private_inputs)
                continue

            if cons.literal == "equals":
                cc = self.circuits[curr]
                cc.constraints.append(
                    Constraint(
                        op="*", v1=cons.v2, v2="1", out=cons.v1,
                        literal=(
                            f"equals({cons.v1}, {cons.v2}): "
                            f"{cons.v1}=={cons.v2} * 1"
                        ),
                    )
                )
                cc.constraints.append(
                    Constraint(
                        op="*", v1=cons.v1, v2="1", out=cons.v2,
                        literal=(
                            f"equals({cons.v1}, {cons.v2}): "
                            f"{cons.v2}=={cons.v1} * 1"
                        ),
                    )
                )
                continue

            if cons.literal == "return":
                curr = ""
                continue

            if cons.literal == "call":
                callee = self.circuits[cons.op]
                suffix = str(calls_count)
                rename: Dict[str, str] = {}
                decl = callee.constraints[0]
                for i, arg in enumerate(cons.private_inputs):
                    rename[decl.private_inputs[i] + suffix] = arg
                rename[callee.constraints[-1].out + suffix] = cons.out
                sub = lambda name: rename.get(name, name)
                cc = self.circuits[curr]
                for body in callee.constraints[1:]:
                    nc = Constraint(
                        op=body.op,
                        v1=sub(body.v1 + suffix),
                        v2=sub(body.v2 + suffix),
                        out=sub(body.out + suffix),
                    )
                    nc.literal = f"{nc.out}={nc.v1}{nc.op}{nc.v2}"
                    cc.constraints.append(nc)
                for sig in callee.signals:
                    _add_signal(cc, sub(sig + suffix))
                calls_count += 1
                continue

            if cons.literal == "import":
                path = cons.out
                resolved = path
                if not os.path.exists(resolved) and self.base_dir:
                    resolved = os.path.join(self.base_dir, path)
                if not os.path.exists(resolved):
                    raise ParseError(f"imported path error: {path}")
                with open(resolved) as fh:
                    inner = Parser(fh.read(), base_dir=os.path.dirname(resolved))
                try:
                    inner.parse()
                except ParseError as e:
                    # the imported file registers funcs; its own lack of a
                    # main is expected (reference ignores the inner error,
                    # parser.go:319-327)
                    if "main" not in str(e):
                        raise
                # mirror the reference's global-map replacement semantics
                self.circuits = inner.circuits
                continue

            if curr not in self.circuits:
                raise ParseError(f"statement outside any func: {cons.literal!r}")
            cc = self.circuits[curr]
            cc.constraints.append(cons)
            if _is_value(cons.v1) is None:
                _add_signal(cc, cons.v1)
            if _is_value(cons.v2) is None:
                _add_signal(cc, cons.v2)
            _add_signal(cc, cons.out)

        main = self.circuits["main"]
        main.n_vars = len(main.signals)
        main.n_signals = len(main.signals)
        if not main_exist:
            raise ParseError("No 'main' func declared")
        return main


def _add_signal(circuit: Circuit, name: str) -> None:
    # membership via the circuit's O(1) index cache (a `name in list` scan
    # here made parsing quadratic — fatal at 2^16+ constraints)
    m = circuit._index_map()
    if name not in m:
        circuit.signals.append(name)
        m[name] = len(circuit.signals) - 1


def parse_source(text: str, base_dir: Optional[str] = None) -> Circuit:
    return Parser(text, base_dir=base_dir).parse()


def parse_file(path: str) -> Circuit:
    with open(path) as fh:
        return Parser(fh.read(), base_dir=os.path.dirname(os.path.abspath(path))).parse()
