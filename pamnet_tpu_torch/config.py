"""Model configuration of the port: the fields of ``pamnet_tpu.config.
PAMNetConfig`` that the scoring and QM9 training paths read.  The JAX package's ELL, Pallas,
lane-pack and scan knobs arrange data for the TPU and have no meaning here."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PAMNetConfig:
    """Hyperparameters of a PAMNet model (reference ``Config``, models.py:12-19).

    ``flow`` sets where the global layer aggregates: ``"source_to_target"``
    at ``edge_index[1]`` (dst), ``"target_to_source"`` at ``edge_index[0]``
    (src).  ``fold_sbf``: None folds the sbf MLP through the triplet gather
    exactly where the fused ``sbf_modulate`` kernel is built for
    ``(num_spherical, dim)``; True/False force it.  (The JAX model's
    ``fuse_sbf_gather`` has no counterpart: a folded stage always runs fused.)
    """

    dataset: str = "QM9"
    dim: int = 128
    n_layer: int = 6
    cutoff_l: float = 5.0
    cutoff_g: float = 5.0
    flow: str = "source_to_target"
    num_spherical: int = 7
    num_radial: int = 6
    envelope_exponent: int = 5
    num_rbf: int = 16
    num_node_features: int = 18
    variant: str = "full"
    compute_dtype: str = "float32"
    fold_sbf: bool | None = None

    def __post_init__(self):
        if self.flow not in ("source_to_target", "target_to_source"):
            raise ValueError(f"invalid flow: {self.flow}")
        if self.variant not in ("full", "s"):
            raise ValueError(f"invalid variant: {self.variant}")
        if self.compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r}: the port computes in "
                "float32 only"
            )

    @property
    def dataset_kind(self) -> str:
        """Which forward branch this dataset takes (reference: models.py:104-160)."""
        name = self.dataset
        if name[:3].lower() == "rna":
            return "rna"
        if name == "QM9":
            return "qm9"
        if name == "PDBbind":
            return "pdbbind"
        raise ValueError(
            "Invalid dataset. If you are using any dataset related to RNA 3D "
            "structure prediction, be sure to use 'rna' as the first 3 "
            "characters of the dataset name."
        )

    @property
    def num_atom_types(self) -> int:
        return atom_type_count(self.dataset_kind)


def atom_type_count(dataset_kind: str) -> int:
    """Rows of the atom-type embedding: RNA C/N/O only (reference:
    models.py:32), otherwise H/C/N/O/F."""
    return 3 if dataset_kind == "rna" else 5


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or implied) and absent, so a
    run never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
