"""Minimal SMARTS atom-pattern evaluator for the featurizer's five flag
(the port's copy of ``pamnet_tpu/data/smarts.py``)
patterns (reference: utils/featurizer.py:124-131, matched there via
OpenBabel ``pybel.Smarts``).

The reference's patterns are all SINGLE-ATOM bracket expressions whose only
structure is one level of recursive environments (``$(...)``) over linear
chains, so a full SMARTS engine is unnecessary.  Supported subset:

  primitives   ``#n`` atomic number - ``*`` any - element symbols
               (uppercase = aliphatic, lowercase = aromatic) - ``a``/``A``
               aromatic/aliphatic - ``Hn`` attached-H count - ``Xn`` total
               connectivity (incl. H) - ``vn`` total bond-order valence -
               ``+n``/``-n`` (or repeated signs) formal charge - ``^n``
               hybridization (OpenBabel extension) - ``R``/``r`` ring
               membership (ring-count/size qualifiers unsupported)
  logic        ``!`` not - ``&``/adjacency high-AND - ``,`` or - ``;``
               low-AND (SMARTS precedence: ``!`` > ``&`` > ``,`` > ``;``)
  recursion    ``$(chain)`` where chain = atom (bond? atom)* with bonds
               ``~`` any, ``-`` single, ``=`` double, ``#`` triple, ``:``
               aromatic, default single-or-aromatic; branches are not
               supported (none of the reference patterns use them)

Evaluation happens over a :class:`PerceivedMol` — per-atom perception
arrays the caller derives from its chemistry source (here: the mol2 parser
+ documented perception approximations in ``data/featurizer.py``).  This
separates the pattern *semantics* (exactly the reference SMARTS strings)
from the *perception* (formal charges, aromaticity, hybridization), which
is the only remaining OpenBabel-parity caveat.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Element symbols valid inside bracket expressions.  Uppercase entries match
# aliphatic atoms only; the lowercase aromatic forms are generated for the
# subset of elements SMARTS allows to be aromatic.
_ELEMENTS = {
    "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16,
    "Cl": 17, "K": 19, "Ca": 20, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28,
    "Cu": 29, "Zn": 30, "As": 33, "Se": 34, "Br": 35, "I": 53,
    # No H-prefixed symbols (He/Hg/Ho): inside brackets 'H' always parses
    # as an attached-hydrogen count (SMARTS semantics; hydrogen ATOMS are
    # written [#1], as the reference's acceptor pattern does).
}
_AROMATIC_ELEMENTS = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16,
                      "se": 34, "as": 33}


@dataclasses.dataclass
class PerceivedMol:
    """Per-atom perception arrays the evaluator reads.  ``neighbors[i]`` is
    a list of ``(j, order)`` covering ALL atoms (including hydrogens);
    ``order`` is the mol2 bond-order string ("1", "2", "3", "am", "ar",
    ...)."""

    z: np.ndarray  # (N,) int atomic numbers
    aromatic: np.ndarray  # (N,) bool
    formal_charge: np.ndarray  # (N,) int
    num_h: np.ndarray  # (N,) int attached hydrogens
    connectivity: np.ndarray  # (N,) int X: neighbor count incl. H
    valence: np.ndarray  # (N,) int v: bond-order sum incl. H
    hyb: np.ndarray  # (N,) int OpenBabel-style hybridization (0 = unknown)
    in_ring: np.ndarray  # (N,) bool
    neighbors: list  # list[list[tuple[int, str]]]


class _Prim:
    __slots__ = ("kind", "value")

    def __init__(self, kind, value=None):
        self.kind = kind
        self.value = value

    def match(self, mol: PerceivedMol, i: int) -> bool:
        k, v = self.kind, self.value
        if k == "any":
            return True
        if k == "num":
            return int(mol.z[i]) == v
        if k == "elem":
            sym_z, arom = v
            if int(mol.z[i]) != sym_z:
                return False
            return bool(mol.aromatic[i]) == arom
        if k == "arom":
            return bool(mol.aromatic[i]) == v
        if k == "hcount":
            return int(mol.num_h[i]) == v
        if k == "conn":
            return int(mol.connectivity[i]) == v
        if k == "valence":
            return int(mol.valence[i]) == v
        if k == "charge":
            return int(mol.formal_charge[i]) == v
        if k == "hyb":
            return int(mol.hyb[i]) == v
        if k == "ring":
            return bool(mol.in_ring[i])
        if k == "rec":
            return _match_chain(v, mol, i)
        raise AssertionError(k)

    def match_vec(self, mol: PerceivedMol, active: np.ndarray) -> np.ndarray:
        """Vectorized match over all atoms; results only need to be valid
        where ``active`` (per-atom recursive walks are restricted to it)."""
        k, v = self.kind, self.value
        n = len(mol.z)
        if k == "any":
            return np.ones(n, dtype=bool)
        if k == "num":
            return mol.z == v
        if k == "elem":
            sym_z, arom = v
            return (mol.z == sym_z) & (mol.aromatic == arom)
        if k == "arom":
            return mol.aromatic == v
        if k == "hcount":
            return mol.num_h == v
        if k == "conn":
            return mol.connectivity == v
        if k == "valence":
            return mol.valence == v
        if k == "charge":
            return mol.formal_charge == v
        if k == "hyb":
            return mol.hyb == v
        if k == "ring":
            return mol.in_ring.copy()
        if k == "rec":
            atoms, bonds = v
            if len(atoms) == 1:
                # Single-atom environment: pure expression on the candidate.
                return atoms[0].match_vec(mol, active)
            out = np.zeros(n, dtype=bool)
            for i in np.flatnonzero(active):
                out[i] = _match_chain(v, mol, int(i))
            return out
        raise AssertionError(k)


class _Not:
    __slots__ = ("x",)

    def __init__(self, x):
        self.x = x

    def match(self, mol, i):
        return not self.x.match(mol, i)

    def match_vec(self, mol, active):
        return ~self.x.match_vec(mol, active)


class _And:
    __slots__ = ("xs",)

    def __init__(self, xs):
        self.xs = xs

    def match(self, mol, i):
        return all(x.match(mol, i) for x in self.xs)

    def match_vec(self, mol, active):
        acc = active.copy()
        for x in self.xs:
            acc &= x.match_vec(mol, acc)
        return acc


class _Or:
    __slots__ = ("xs",)

    def __init__(self, xs):
        self.xs = xs

    def match(self, mol, i):
        return any(x.match(mol, i) for x in self.xs)

    def match_vec(self, mol, active):
        res = np.zeros(len(mol.z), dtype=bool)
        remaining = active.copy()
        for x in self.xs:
            res |= x.match_vec(mol, remaining) & remaining
            remaining &= ~res
        return res


def _bond_matches(kind: str, order: str) -> bool:
    if kind == "~":
        return True
    aromatic = order == "ar"
    if kind == ":":
        return aromatic
    if kind == "-":
        return not aromatic and order not in ("2", "3")
    if kind == "=":
        return order == "2"
    if kind == "#":
        return order == "3"
    if kind == "default":  # single-or-aromatic
        return aromatic or order not in ("2", "3")
    raise AssertionError(kind)


def _match_chain(chain, mol: PerceivedMol, i: int) -> bool:
    """Match a linear recursive-SMARTS chain rooted at atom ``i`` (the
    candidate atom is the chain's FIRST atom, per SMARTS recursion
    semantics).  Atoms along one match must be distinct."""
    atoms, bonds = chain  # (exprs, bond kinds), len(bonds) == len(atoms)-1

    def walk(pos: int, at: int, used: frozenset) -> bool:
        if not atoms[pos].match(mol, at):
            return False
        if pos + 1 == len(atoms):
            return True
        for j, order in mol.neighbors[at]:
            if j in used:
                continue
            if _bond_matches(bonds[pos], order) and walk(
                pos + 1, j, used | {j}
            ):
                return True
        return False

    return walk(0, i, frozenset({i}))


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.p = 0

    def error(self, msg: str):
        raise ValueError(f"SMARTS parse error at {self.p} in {self.s!r}: {msg}")

    def peek(self):
        return self.s[self.p] if self.p < len(self.s) else ""

    def take_digits(self, default=None):
        start = self.p
        while self.peek().isdigit():
            self.p += 1
        if start == self.p:
            return default
        return int(self.s[start:self.p])

    # expr := or_seq (';' or_seq)*        (low AND)
    # or_seq := and_seq (',' and_seq)*
    # and_seq := unary (('&')? unary)*    (high AND / adjacency)
    # unary := '!' unary | primitive
    def parse_expr(self, stop: str):
        xs = [self.parse_or(stop)]
        while self.peek() == ";":
            self.p += 1
            xs.append(self.parse_or(stop))
        return xs[0] if len(xs) == 1 else _And(xs)

    def parse_or(self, stop: str):
        xs = [self.parse_and(stop)]
        while self.peek() == ",":
            self.p += 1
            xs.append(self.parse_and(stop))
        return xs[0] if len(xs) == 1 else _Or(xs)

    def parse_and(self, stop: str):
        xs = [self.parse_unary(stop)]
        while True:
            c = self.peek()
            if c == "&":
                self.p += 1
                xs.append(self.parse_unary(stop))
            elif c and c not in ",;" and c != stop:
                xs.append(self.parse_unary(stop))
            else:
                break
        return xs[0] if len(xs) == 1 else _And(xs)

    def parse_unary(self, stop: str):
        if self.peek() == "!":
            self.p += 1
            return _Not(self.parse_unary(stop))
        return self.parse_primitive()

    def parse_primitive(self):
        c = self.peek()
        if c == "*":
            self.p += 1
            return _Prim("any")
        if c == "#":
            self.p += 1
            n = self.take_digits()
            if n is None:
                self.error("expected digits after #")
            return _Prim("num", n)
        if c == "+":
            count = 0
            while self.peek() == "+":
                count += 1
                self.p += 1
            n = self.take_digits()
            return _Prim("charge", n if n is not None else count)
        if c == "-":
            count = 0
            while self.peek() == "-":
                count += 1
                self.p += 1
            n = self.take_digits()
            return _Prim("charge", -(n if n is not None else count))
        if c == "H":
            self.p += 1
            return _Prim("hcount", self.take_digits(default=1))
        if c == "X":
            self.p += 1
            return _Prim("conn", self.take_digits(default=1))
        if c == "v":
            self.p += 1
            return _Prim("valence", self.take_digits(default=1))
        if c == "^":
            self.p += 1
            n = self.take_digits()
            if n is None:
                self.error("expected digits after ^")
            return _Prim("hyb", n)
        if c in ("R", "r"):
            self.p += 1
            if self.peek().isdigit():
                self.error("ring count/size qualifiers unsupported")
            return _Prim("ring")
        if c == "a":
            # aromatic-any unless part of a two-letter aromatic symbol (as)
            if self.s[self.p:self.p + 2] == "as":
                self.p += 2
                return _Prim("elem", (_AROMATIC_ELEMENTS["as"], True))
            self.p += 1
            return _Prim("arom", True)
        if c == "A":
            nxt = self.s[self.p:self.p + 2]
            if nxt in _ELEMENTS:  # Al, As
                self.p += 2
                return _Prim("elem", (_ELEMENTS[nxt], False))
            self.p += 1
            return _Prim("arom", False)
        if c == "$":
            self.p += 1
            if self.peek() != "(":
                self.error("expected ( after $")
            self.p += 1
            chain = self.parse_chain()
            if self.peek() != ")":
                self.error("expected ) closing recursive SMARTS")
            self.p += 1
            return _Prim("rec", chain)
        # Element symbols: try two-letter first, then one.
        two = self.s[self.p:self.p + 2]
        if len(two) == 2 and two in _ELEMENTS:
            self.p += 2
            return _Prim("elem", (_ELEMENTS[two], False))
        if len(two) == 2 and two in _AROMATIC_ELEMENTS:
            self.p += 2
            return _Prim("elem", (_AROMATIC_ELEMENTS[two], True))
        if c in _ELEMENTS:
            self.p += 1
            return _Prim("elem", (_ELEMENTS[c], False))
        if c in _AROMATIC_ELEMENTS:
            self.p += 1
            return _Prim("elem", (_AROMATIC_ELEMENTS[c], True))
        self.error(f"unsupported primitive {c!r}")

    def parse_chain(self):
        """Linear chain for recursive SMARTS: atom (bond? atom)*."""
        atoms = [self.parse_chain_atom()]
        bonds = []
        while self.peek() and self.peek() != ")":
            c = self.peek()
            if c == "(":
                self.error("branches in recursive SMARTS unsupported")
            if c in "~-=#:":
                bonds.append("~" if c == "~" else c)
                self.p += 1
            else:
                bonds.append("default")
            atoms.append(self.parse_chain_atom())
        return atoms, bonds

    def parse_chain_atom(self):
        c = self.peek()
        if c == "[":
            self.p += 1
            e = self.parse_expr("]")
            if self.peek() != "]":
                self.error("expected ]")
            self.p += 1
            return e
        if c == "*":
            self.p += 1
            return _Prim("any")
        # Bare element symbol outside brackets.
        two = self.s[self.p:self.p + 2]
        if len(two) == 2 and two in _ELEMENTS:
            self.p += 2
            return _Prim("elem", (_ELEMENTS[two], False))
        if c in _ELEMENTS:
            self.p += 1
            return _Prim("elem", (_ELEMENTS[c], False))
        if c in _AROMATIC_ELEMENTS:
            self.p += 1
            return _Prim("elem", (_AROMATIC_ELEMENTS[c], True))
        self.error(f"unsupported chain atom {c!r}")


class SmartsPattern:
    """A compiled single-atom SMARTS pattern."""

    def __init__(self, smarts: str):
        self.smarts = smarts
        if not (smarts.startswith("[") and smarts.endswith("]")):
            raise ValueError(
                f"only single-atom bracket patterns supported: {smarts!r}"
            )
        p = _Parser(smarts[1:-1])
        self.expr = p.parse_expr("")
        if p.p != len(p.s):
            p.error("trailing input")

    def match_atom(self, mol: PerceivedMol, i: int) -> bool:
        return self.expr.match(mol, i)

    def match_all(self, mol: PerceivedMol) -> np.ndarray:
        """Vectorized evaluation over all atoms: primitives and single-atom
        recursive environments run as numpy array ops; only multi-atom
        recursive chains fall back to per-atom walks, restricted to atoms
        still live after the preceding (left-to-right) conjuncts."""
        return self.expr.match_vec(
            mol, np.ones(len(mol.z), dtype=bool)
        ).astype(bool)


def compile_smarts(smarts: str) -> SmartsPattern:
    return SmartsPattern(smarts)
