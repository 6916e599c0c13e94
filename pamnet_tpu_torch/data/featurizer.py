"""PDBbind atom featurizer (the port's copy of ``pamnet_tpu/data/featurizer.py``,
the same 18 float32 columns bit for bit): 18 features per heavy atom, matching the
reference's OpenBabel-based featurizer layout (reference: utils/featurizer.py,
consumed by models.py:35 ``init_linear(18, dim)``):

  [0:9]   one-hot atom class: B, C, N, O, P, S, Se, halogen, metal
          (reference: featurizer.py:57-82; unknown types encode all-zeros)
  [9]     hybridization (1/2/3)
  [10]    heavy-atom degree
  [11]    heteroatom degree (bonded N/O/S/P/...; non-C, non-H neighbors)
  [12]    partial charge (taken from the mol2 file's charge column)
  [13:18] SMARTS-defined flags: hydrophobic, aromatic, acceptor, donor, ring
          (reference SMARTS at featurizer.py:124-131)

The five flags are computed by evaluating the reference's LITERAL SMARTS
patterns (copied verbatim below — they are the spec) with the first-party
SMARTS-subset engine in ``data/smarts.py``, over a perception
layer derived from the parsed mol2.  The remaining OpenBabel-parity caveats
are therefore confined to *perception*, not pattern semantics:

* partial charges come from the mol2 file (PDBbind ships Gasteiger-style
  charges) rather than being recomputed;
* formal charges are perceived from SYBYL types (``N.4`` -> +1, matching
  OpenBabel's mol2 typer) plus structure for the cations the patterns test
  (``*+1``): tetravalent N (ammonium/quaternary), tetravalent P
  (phosphonium), trivalent-v3 S (sulfonium); anions default to 0 (mol2
  carries no formal charges) — affects only the ``-``/``-2``/``-3`` donor
  exclusions for rare H-bearing anions;
* H counts = explicit hydrogens + an implicit complement from the
  element's typical-valence ladder (OpenBabel's model: the smallest
  standard valence >= the bond-order sum fills up with hydrogens), so
  under-protonated files perceive like OpenBabel; isolated atoms are
  treated as ions (no implicit H — a bare Cl is chloride, not HCl) and
  ``O.co2`` carboxylate oxygens never protonate;
* hybridization comes from the SYBYL type suffix (``.cat`` -> sp2 like
  OpenBabel's planar-cation perception; other exotic suffixes default to
  sp3); suffix-less types of the organic elements OpenBabel's HYB table
  covers (B/C/N/O/Si/P/S/As/Se) are perceived from their bond orders, and
  suffix-less halogen/metal/ion types keep hyb 0;
* aromaticity = SYBYL ``.ar`` types / ``ar`` bonds PLUS a Hueckel
  perception (``_huckel_aromatic``) so Kekule-written rings (alternating
  1/2 bonds, no aromatic marks) perceive aromatic like OpenBabel, which
  re-runs its own aromaticity model on read: per-ring 4n+2 over simple
  3-7 cycles plus a fused-ENVELOPE pass (edge-sharing rings union into
  systems tested with the same per-atom pi model), so azulene's 10-pi
  bicyclic marks aromatic while pentalene (8 pi) stays out — both
  registry-locked fixtures.

The JAX package's ``pamnet_tpu/data/featurizer_divergences.py`` enumerates
the concrete divergence cases these approximations produce; the port's
tests hold this copy to its ``ours`` column.
"""

from __future__ import annotations

import numpy as np

from pamnet_tpu_torch.data.mol2 import Mol2
from pamnet_tpu_torch.data.smarts import PerceivedMol, compile_smarts

# The reference's SMARTS definitions, verbatim (utils/featurizer.py:124-131).
REFERENCE_SMARTS = {
    "hydrophobic": "[#6+0!$(*~[#7,#8,F]),SH0+0v2,s+0,S^3,Cl+0,Br+0,I+0]",
    "aromatic": "[a]",
    "acceptor":
        "[!$([#1,#6,F,Cl,Br,I,o,s,nX3,#7v5,#15v5,#16v4,#16v6,*+1,*+2,*+3])]",
    "donor": "[!$([#6,H0,-,-2,-3]),$([!H0;#7,#8,#9])]",
    "ring": "[r]",
}
_COMPILED = {k: compile_smarts(v) for k, v in REFERENCE_SMARTS.items()}

_METALS = set(
    [3, 4, 11, 12, 13]
    + list(range(19, 32))
    + list(range(37, 51))
    + list(range(55, 84))
    + list(range(87, 104))
)

_HALOGENS = {9, 17, 35, 53}

_ATOM_CLASS = {}
for _code, _nums in enumerate(
    [{5}, {6}, {7}, {8}, {15}, {16}, {34}, _HALOGENS, _METALS]
):
    for _z in _nums:
        _ATOM_CLASS[_z] = _code

FEATURE_NAMES = [
    "B", "C", "N", "O", "P", "S", "Se", "halogen", "metal",
    "hyb", "heavydegree", "heterodegree", "partialcharge",
    "hydrophobic", "aromatic", "acceptor", "donor", "ring",
]


def _hybridization(sybyl: str) -> int:
    """OpenBabel-style hyb value from the SYBYL type suffix (-1 = no
    suffix; the caller perceives those from bond orders where OpenBabel's
    HYB table would).

    Sulfoxide/sulfone sulfur (S.O / S.O2) is tetrahedral -> sp3, matching
    OpenBabel's electron-domain assignment; C.cat (guanidinium-type planar
    cation) is sp2 like OpenBabel's perception; suffixes compare
    case-insensitively (writers emit both S.O2 and S.o2)."""
    if "." not in sybyl:
        return -1
    suffix = sybyl.split(".", 1)[1].lower()
    if suffix == "1":
        return 1
    if suffix in ("2", "ar", "am", "co2", "pl3", "cat"):
        return 2
    if suffix in ("3", "4", "o", "o2", "th", "t3"):
        return 3
    return 3


# Elements whose suffix-less SYBYL types get bond-order hybridization
# perception (the organic set OpenBabel's HYB typer table covers); other
# suffix-less types (halogens, metals, ions) keep hyb 0.
_BARE_HYB_ELEMENTS = {5, 6, 7, 8, 14, 15, 16, 33, 34}


def _bare_hybridization(z: int, orders: list[str]) -> int:
    """Bond-order hybridization for a suffix-less SYBYL type: triple or
    cumulated double bonds -> sp, any double/aromatic -> sp2, all single ->
    sp3 (e.g. bare divalent Se in selenoethers perceives sp3 like
    OpenBabel)."""
    if int(z) not in _BARE_HYB_ELEMENTS or not orders:
        return 0
    n_triple = sum(o == "3" for o in orders)
    n_double = sum(o == "2" for o in orders)
    if n_triple or n_double >= 2:
        return 1
    if n_double or any(o == "ar" for o in orders):
        return 2
    return 3


# Typical-valence ladders for the implicit-hydrogen complement (OpenBabel's
# model: implicit H fill the smallest standard valence >= the bond-order
# sum).  Charge-sensitive elements (N/O/P/S family) shift the ladder by the
# formal charge (N+ -> 4, O- -> 1).
_TYPICAL_VALENCES = {
    5: (3,), 6: (4,), 7: (3,), 8: (2,), 9: (1,),
    14: (4,), 15: (3, 5), 16: (2, 4, 6),
    17: (1,), 34: (2, 4, 6), 35: (1,), 53: (1,),
}
_CHARGE_ADJUSTED = {7, 8, 15, 16, 34}


def _implicit_h(z: int, sybyl: str, bosum: int, conn: int, fc: int) -> int:
    """Implicit hydrogens on one atom: typical valence minus bond-order sum.

    Isolated atoms (conn == 0) are ions, not hydrides, and O.co2
    carboxylate oxygens never carry H (their formal charge is delocalized,
    which mol2 cannot express)."""
    ladder = _TYPICAL_VALENCES.get(int(z))
    if ladder is None or conn == 0 or sybyl.lower() == "o.co2":
        return 0
    for tv in ladder:
        if int(z) in _CHARGE_ADJUSTED:
            tv += fc
        if tv >= bosum:
            return tv - bosum
    return 0


# SYBYL bond-order values for valence accounting (TRIPOS bond types).
_ORDER_VALENCE = {
    "1": 1.0, "2": 2.0, "3": 3.0, "am": 1.0, "ar": 1.5,
    "du": 1.0, "un": 1.0, "nc": 0.0,
}


# Elements that can sit on an aromatic ring in the Hueckel perception below
# (sp2-capable p-block set; metals/others fail the ring).
_AROMATIC_ELEMENTS = {5, 6, 7, 8, 15, 16, 33, 34}


def _simple_cycles(n: int, adj, min_len: int = 3, max_len: int = 7):
    """All simple cycles of length [min_len, max_len] as atom frozensets.

    Bounded DFS anchored at each cycle's minimal vertex (paths only visit
    atoms > start), deduped across direction by the atom set.  Molecular
    graphs are near-planar with degree <= 4, so this is cheap at PDBbind
    pocket sizes; a global cap guards pathological inputs."""
    cycles: set[frozenset] = set()
    for start in range(n):
        stack = [(start, (start,))]
        while stack:
            v, path = stack.pop()
            for w in adj[v]:
                if w == start and len(path) >= min_len:
                    cycles.add(frozenset(path))
                elif w > start and w not in path and len(path) < max_len:
                    stack.append((w, path + (w,)))
            if len(cycles) > 20000:  # pathological density guard
                return cycles
    return cycles


def _ring_pi(ring, z, nbrs):
    """Pi-electron count an atom set contributes to its (ring or fused-
    envelope) conjugated system, or ``None`` if any member disqualifies it.

    Per-atom contributions (the Daylight-style model OpenBabel 3
    implements): double or ``ar`` bond to another member -> 1; exocyclic
    double bond -> 0 (still sp2, e.g. quinone carbons); otherwise a lone
    pair -> 2 for N/O/S/Se/P with all-single bonds (pyrrole/furan/
    thiophene).  Disqualifiers: non-sp2-capable element, triple or
    cumulated double bonds, saturated C; and the system as a whole must
    contain at least one in-system double/``ar`` bond — lone pairs alone
    cannot make a pi system (OpenBabel requires sp2/conjugation evidence),
    else a carbon-free saturated heterocycle (pentazolidine, cyclo-S6)
    would count 2 pi per atom and falsely hit 4n+2 (ADVICE r4)."""
    pi = 0
    any_multiple_in = False
    for v in ring:
        if int(z[v]) not in _AROMATIC_ELEMENTS:
            return None
        doubles_in = doubles_out = ar_in = 0
        for w, o in nbrs[v]:
            if o == "3":
                return None
            if o == "2":
                if w in ring:
                    doubles_in += 1
                else:
                    doubles_out += 1
            elif o == "ar" and w in ring:
                ar_in += 1
        if doubles_in + doubles_out > 1:
            return None  # sp / cumulated double: not aromatic-capable
        if doubles_in or ar_in:
            pi += 1
            any_multiple_in = True
        elif doubles_out:
            pi += 0  # sp2 but contributes no ring electrons (quinone C)
        elif int(z[v]) in (7, 8, 15, 16, 34):
            pi += 2  # lone pair (pyrrole N, furan O, thiophene S)
        else:
            return None  # saturated C/B: breaks conjugation
    if not any_multiple_in:
        return None  # all-lone-pair "system": no conjugation evidence
    return pi


def _huckel_aromatic(n: int, z, nbrs) -> np.ndarray:
    """OpenBabel-style aromaticity perception over the bond graph, so
    Kekule-written files (no ``.ar`` types / ``ar`` bonds) perceive like
    OpenBabel, which re-runs its aromaticity model on read rather than
    trusting the file (reference featurizer feeds the ``[a]`` pattern,
    utils/featurizer.py:124-131).

    Two passes of the same 4n+2 test (:func:`_ring_pi`):

    1. every simple 3-7 cycle on its own (benzene, pyridine, thiophene...);
    2. fused-ring ENVELOPES — CAPABLE base cycles (every member passes the
       per-atom checks) sharing >= 2 atoms (an edge, for simple cycles)
       union into edge-connected systems, and any system whose combined
       atom set passes 4n+2 marks all members.  This is what makes azulene
       aromatic (each of the 5/7 rings fails alone; the fused 10-atom
       system counts 10 pi), while pentalene (8 pi) and biphenylene
       (12 pi) envelopes correctly stay out.  Disqualified rings
       (sp3/metal/cumulated members) are excluded from the union rather
       than killing it, so a saturated ring fused onto azulene leaves the
       10-pi system intact.  A FAILING union recurses into its
       sub-systems (remove one ring, re-split into edge-connected
       components, bounded), so a capable 4n ring fused onto azulene no
       longer hides the 10-pi azulene subsystem — mirroring OpenBabel,
       whose cycle traversal (typer.cpp) tests each cycle/system
       independently of the maximal envelope (closed the round-4
       azulene-plus-4n-ring registered divergence)."""
    arom = np.zeros(n, dtype=bool)
    # Prune the cycle search to atoms that could belong to a qualifying
    # ring: members contribute via an incident double/ar bond or (hetero)
    # lone pair, and saturated C always fails _ring_pi — so restrict the
    # DFS to that subgraph.  On real pocket mol2 files (mostly saturated
    # or explicitly ar-marked carbon) this removes most of the
    # O(n * degree^6) Python DFS cost (ADVICE r4); a molecule with no
    # double/ar bonds at all skips the pass outright (no ring can carry
    # the required in-system multiple bond).
    candidate = np.zeros(n, dtype=bool)
    any_multiple = False
    for v in range(n):
        zv = int(z[v])
        if zv not in _AROMATIC_ELEMENTS:
            continue
        has_multi = any(o in ("2", "ar") for _, o in nbrs[v])
        any_multiple = any_multiple or has_multi
        candidate[v] = has_multi or zv in (7, 8, 15, 16, 34)
    if not any_multiple:
        return arom
    adj = [
        [w for w, _ in nbrs[v] if candidate[w]] if candidate[v] else []
        for v in range(n)
    ]
    capable: list[frozenset] = []
    for ring in _simple_cycles(n, adj):
        pi = _ring_pi(ring, z, nbrs)
        if pi is None:
            continue
        capable.append(ring)
        if pi % 4 == 2:
            for v in ring:
                arom[v] = True

    # ---- fused envelopes (union-find over edge-sharing CAPABLE cycles) ----
    # Only rings whose every member is aromatic-capable join a system: a
    # disqualified ring (sp3/metal/cumulated member) must not kill the
    # envelope of its capable neighbors — a saturated cyclopentane fused
    # onto azulene leaves azulene's 10-pi system intact (registry fixture).
    # A union of capable rings can itself never return None from _ring_pi
    # (each atom keeps >= the in-ring doubles/ar that qualified it), so the
    # envelope test below is a pure 4n+2 parity check.  Guard: pathological
    # inputs that hit the _simple_cycles density cap skip the envelope pass
    # (per-ring marks stand; real molecules have tens of rings).
    if 2 <= len(capable) <= 2000:
        # Ring-adjacency graph: rings sharing >= 2 atoms (an edge, for
        # simple cycles) are fused.
        by_atom: dict[int, list[int]] = {}
        for i, ring in enumerate(capable):
            for v in ring:
                by_atom.setdefault(v, []).append(i)
        radj: list[set[int]] = [set() for _ in capable]
        for i, ring in enumerate(capable):
            shared: dict[int, int] = {}
            for v in ring:
                for k in by_atom[v]:
                    if k > i:
                        shared[k] = shared.get(k, 0) + 1
            for k, cnt in shared.items():
                if cnt >= 2:
                    radj[i].add(k)
                    radj[k].add(i)

        def components(idxs: frozenset) -> list[frozenset]:
            left = set(idxs)
            out = []
            while left:
                comp, stack = set(), [left.pop()]
                while stack:
                    i = stack.pop()
                    comp.add(i)
                    for k in radj[i]:
                        if k in left:
                            left.remove(k)
                            stack.append(k)
                out.append(frozenset(comp))
            return out

        seen: set[frozenset] = set()

        def search(ring_idxs: frozenset) -> None:
            """Test the union of an edge-connected ring set; on 4n+2 mark
            its atoms, else recurse into every sub-system reachable by
            removing one member ring (bounded by ``seen``)."""
            if ring_idxs in seen or len(seen) > 256:
                return
            seen.add(ring_idxs)
            if len(ring_idxs) <= 1:
                return  # single rings were tested in pass 1
            atoms = frozenset().union(*(capable[i] for i in ring_idxs))
            pi = _ring_pi(atoms, z, nbrs)
            if pi is not None and pi % 4 == 2:
                for v in atoms:
                    arom[v] = True
                return
            for r in ring_idxs:
                for comp in components(ring_idxs - {r}):
                    search(comp)

        for comp in components(frozenset(range(len(capable)))):
            search(comp)
    return arom


def _ring_atoms(n: int, bonds) -> np.ndarray:
    """Atoms lying on at least one cycle.

    In a simple graph, every non-bridge edge is on a cycle, so ring atoms are
    exactly the endpoints of non-bridge edges (bridges via iterative Tarjan
    lowlink DFS)."""
    adj = [[] for _ in range(n)]
    for ei, (a, b, _) in enumerate(bonds):
        adj[a].append((b, ei))
        adj[b].append((a, ei))
    disc = [-1] * n
    low = [0] * n
    is_bridge = [False] * len(bonds)
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        disc[root] = low[root] = timer
        timer += 1
        stack = [(root, -1, iter(adj[root]))]
        while stack:
            v, pe, it = stack[-1]
            advanced = False
            for w, ei in it:
                if ei == pe:
                    continue
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    stack.append((w, ei, iter(adj[w])))
                    advanced = True
                    break
                low[v] = min(low[v], disc[w])
            if not advanced:
                stack.pop()
                if stack:
                    u = stack[-1][0]
                    low[u] = min(low[u], low[v])
                    if low[v] > disc[u]:
                        is_bridge[pe] = True
    in_ring = np.zeros(n, dtype=bool)
    for ei, (a, b, _) in enumerate(bonds):
        if a != b and not is_bridge[ei]:
            in_ring[a] = in_ring[b] = True
    return in_ring


def perceive_mol2(mol: Mol2) -> PerceivedMol:
    """Perception arrays for SMARTS evaluation (the documented OpenBabel
    approximations live HERE; see the module docstring)."""
    n = len(mol)
    z = mol.atomic_num

    nbrs = [[] for _ in range(n)]
    arom_bond = np.zeros(n, dtype=bool)
    valence = np.zeros(n, dtype=np.float64)
    for a, b, order in mol.bonds:
        nbrs[a].append((b, order))
        nbrs[b].append((a, order))
        if order == "ar":
            arom_bond[a] = arom_bond[b] = True
        v = _ORDER_VALENCE.get(order, 1.0)
        valence[a] += v
        valence[b] += v
    valence = np.round(valence).astype(np.int64)

    # Case-insensitive like every other SYBYL-suffix check here (writers
    # emit "C.ar"/"C.AR" variants; OpenBabel's typer is case-insensitive).
    # File markings are trusted AND the Hueckel model runs on top, so
    # Kekule-written rings (benzene as alternating 1/2 bonds) perceive
    # aromatic like OpenBabel's on-read re-perception.
    aromatic = (
        arom_bond
        | np.array([s.lower().endswith(".ar") for s in mol.sybyl], dtype=bool)
        | _huckel_aromatic(n, z, nbrs)
    )
    conn = np.array([len(nbrs[v]) for v in range(n)], dtype=np.int64)
    num_h = np.array(
        [sum(z[w] == 1 for w, _ in nbrs[v]) for v in range(n)], dtype=np.int64
    )
    hyb = np.array([_hybridization(s) for s in mol.sybyl], dtype=np.int64)
    bare = hyb < 0
    if bare.any():
        orders = [[o for _, o in nbrs[v]] for v in range(n)]
        hyb[bare] = [
            _bare_hybridization(z[v], orders[v]) for v in np.where(bare)[0]
        ]

    # Formal-charge perception for the cations the reference patterns test
    # (*+1): the SYBYL N.4 type is +1 by definition (OpenBabel's mol2 typer
    # marks it charged even when the file under-protonates it), plus
    # structural ammonium/quaternary N, phosphonium P, sulfonium S.  Anions
    # stay 0 (mol2 has no formal charges; documented).
    fc = np.zeros(n, dtype=np.int64)
    fc[np.array([s.lower() == "n.4" for s in mol.sybyl], dtype=bool)] = 1
    fc[(z == 7) & (conn == 4) & (valence == 4)] = 1
    fc[(z == 15) & (conn == 4) & (valence == 4)] = 1
    fc[(z == 16) & (conn == 3) & (valence == 3)] = 1

    # Implicit-hydrogen complement (OpenBabel's typical-valence model) so
    # under-protonated files perceive like OpenBabel: H count, connectivity
    # X, and valence v all include implicit H, exactly as in SMARTS
    # semantics over an OpenBabel molecule.
    impl = np.array(
        [
            _implicit_h(z[v], mol.sybyl[v], int(valence[v]), int(conn[v]),
                        int(fc[v]))
            for v in range(n)
        ],
        dtype=np.int64,
    )
    impl[z == 1] = 0
    num_h = num_h + impl
    conn = conn + impl
    valence = valence + impl

    return PerceivedMol(
        z=z, aromatic=aromatic, formal_charge=fc, num_h=num_h,
        connectivity=conn, valence=valence, hyb=hyb,
        in_ring=_ring_atoms(n, mol.bonds), neighbors=nbrs,
    )


def featurize_mol2(mol: Mol2, molcode: float | None = None):
    """(coords, features) over heavy atoms (reference API:
    Featurizer.get_features, utils/featurizer.py:204-261).  With
    ``molcode=None`` (save_molecule_codes=False) features have width 18,
    matching preprocess_pdbbind.py:82."""
    n = len(mol)
    z = mol.atomic_num
    heavy = z > 1

    pm = perceive_mol2(mol)
    hyb = pm.hyb.astype(np.float32)
    heavydeg = np.array(
        [sum(z[w] > 1 for w, _ in pm.neighbors[v]) for v in range(n)],
        dtype=np.float32,
    )
    heterodeg = np.array(
        [sum(z[w] not in (1, 6) and z[w] > 1 for w, _ in pm.neighbors[v])
         for v in range(n)],
        dtype=np.float32,
    )

    # The five flags: the literal reference SMARTS evaluated over the
    # perception arrays (pattern semantics exact; perception documented).
    flags_by_name = {
        name: pat.match_all(pm) for name, pat in _COMPILED.items()
    }

    feats = np.concatenate(
        [
            np.stack(
                [
                    np.array([_ATOM_CLASS.get(int(a), -1) == c for a in z])
                    for c in range(9)
                ],
                axis=1,
            ).astype(np.float32),
            hyb[:, None],
            heavydeg[:, None],
            heterodeg[:, None],
            mol.charge[:, None].astype(np.float32),
        ],
        axis=1,
    )
    if molcode is not None:
        feats = np.concatenate(
            [feats, np.full((n, 1), float(molcode), np.float32)], axis=1
        )
    flags = np.stack(
        [flags_by_name[k]
         for k in ("hydrophobic", "aromatic", "acceptor", "donor", "ring")],
        axis=1,
    )
    feats = np.concatenate([feats, flags.astype(np.float32)], axis=1)

    if np.isnan(feats).any():
        raise RuntimeError("Got NaN when calculating features")
    return mol.pos[heavy].astype(np.float32), feats[heavy]
