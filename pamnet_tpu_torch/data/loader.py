"""Batch loader: per-structure graph build with the host basis, then padded
batches in order or shuffled per epoch (the inference and training subset
of ``pamnet_tpu.data.loader.GraphLoader``)."""

from __future__ import annotations

import dataclasses

import numpy as np

from pamnet_tpu_torch.config import atom_type_count
from pamnet_tpu_torch.data.batch import (
    PadSizes,
    attach_basis,
    collate_structures,
    precompute_structure,
    structure_counts,
)


class GraphLoader:
    """Iterates padded ``GraphBatch``es over molecules.

    Args:
      mols: molecule dicts with ``z``, ``pos`` and ``y`` (QM9: also the bond
        ``edge_index``).
      pads: a minimum bucket (the caller's high-water pads); any dimension
        this set of molecules exceeds is widened.  None = the worst case of
        this set (sum of the ``batch_size`` largest counts per dimension).
      ladder_pads: pad each batch to the geometric bucket of its own counts,
        capped at ``self.pads``, instead of to ``self.pads`` itself.
      shuffle, seed: a new molecule order every epoch, one permutation per
        epoch from ``np.random.default_rng(seed)``, as the JAX loader draws
        them (so batches hold the same molecules).
      drop_last: drop an epoch's last, partial batch.
      build_perms: batches carry the backward's CSR arrays (training).
    """

    def __init__(self, mols: list[dict], dataset_kind: str, cutoff_l: float,
                 cutoff_g: float, batch_size: int, pads: PadSizes | None = None,
                 ladder_pads: bool = False, align: int = 128,
                 num_spherical: int = 7, num_radial: int = 6,
                 envelope_exponent: int = 5, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, build_perms: bool = False):
        if not mols:
            raise ValueError("GraphLoader needs at least one molecule")
        self.batch_size = batch_size
        self.ladder_pads = ladder_pads
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.build_perms = build_perms
        self._num_atom_types = atom_type_count(dataset_kind)
        self._rng = np.random.default_rng(seed)
        self._align = align
        self.structs = [
            attach_basis(
                precompute_structure(m, dataset_kind, cutoff_l, cutoff_g),
                cutoff_l, num_spherical, num_radial, envelope_exponent,
            )
            for m in mols
        ]
        self._counts = np.array([structure_counts(s) for s in self.structs])
        b = min(batch_size, len(self.structs))
        n, eg, el, t2, t1 = np.sort(self._counts, axis=0)[-b:].sum(axis=0)
        own = PadSizes.for_counts(int(n), max(int(eg), 1), max(int(el), 1),
                                  max(int(t2), 1), max(int(t1), 1), batch_size,
                                  align=align)
        if pads is not None:
            own = PadSizes(*(max(getattr(pads, f.name), getattr(own, f.name))
                             for f in dataclasses.fields(PadSizes)))
        self.pads = own

    def __len__(self) -> int:
        n = len(self.structs)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def num_molecules(self) -> int:
        return len(self.structs)

    def batches(self) -> list[list[int]]:
        """Molecule indices of each batch of the next epoch (draws this
        epoch's permutation when shuffling)."""
        order = np.arange(len(self.structs))
        if self.shuffle:
            order = self._rng.permutation(order)
        out = []
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            out.append(chunk.tolist())
        return out

    def _batch_pads(self, idxs: list[int]) -> PadSizes:
        n, eg, el, t2, t1 = self._counts[idxs].sum(axis=0)
        b = PadSizes.bucketed(int(n), max(int(eg), 1), max(int(el), 1),
                              max(int(t2), 1), max(int(t1), 1), len(idxs),
                              align=self._align)
        return PadSizes(*(min(getattr(b, f.name), getattr(self.pads, f.name))
                          for f in dataclasses.fields(PadSizes)))

    def collate(self, idxs: list[int]):
        """The padded batch of the molecules ``idxs``."""
        pads = self._batch_pads(idxs) if self.ladder_pads else self.pads
        return collate_structures([self.structs[i] for i in idxs], pads,
                                  build_perms=self.build_perms,
                                  num_atom_types=self._num_atom_types)

    def __iter__(self):
        for idxs in self.batches():
            yield self.collate(idxs)
