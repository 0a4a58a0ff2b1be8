"""Flat-code circuit DSL frontend: lexer, parser, R1CS, witness.

Copy of ``go_snark_study_tpu/circuitcompiler/`` (reference: circuitcompiler/
lexer.go, parser.go, circuit.go).
"""

from .circuit import Circuit, CircuitError, Constraint
from .lexer import Scanner
from .parser import ParseError, Parser, parse_file, parse_source

__all__ = [
    "Circuit",
    "CircuitError",
    "Constraint",
    "Scanner",
    "ParseError",
    "Parser",
    "parse_file",
    "parse_source",
]
