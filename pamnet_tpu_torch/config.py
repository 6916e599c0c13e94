"""Model configuration of the port: the fields of ``pamnet_tpu.config.
PAMNetConfig`` that the scoring and training paths read.  The JAX package's ELL, Pallas,
lane-pack and scan knobs arrange data for the TPU and have no meaning here."""

from __future__ import annotations

import dataclasses

import torch

from pamnet_tpu_torch.ops.sbf_modulate import KERNEL_SHAPES


@dataclasses.dataclass(frozen=True)
class PAMNetConfig:
    """Hyperparameters of a PAMNet model (reference ``Config``, models.py:12-19).

    ``flow`` sets where the global layer aggregates: ``"source_to_target"``
    at ``edge_index[1]`` (dst), ``"target_to_source"`` at ``edge_index[0]``
    (src).  ``fold_sbf``: None folds the sbf MLP through the triplet gather
    exactly where the fused ``sbf_modulate`` kernel is built for
    ``(num_spherical, dim)``; True/False force it.  (The JAX model's
    ``fuse_sbf_gather`` has no counterpart: a folded stage always runs fused.)
    ``device_graph`` rebuilds the graph from the positions on the device in
    every forward (``models/device_graph.py``; JAX ``config.py:85-87``).
    ``compute_dtype`` is the type of the message-passing stack's activations
    (JAX's mixed precision, ``models/pamnet.py``): "float32", or "bfloat16"
    with float32 parameters, geometry, sums, fusion and pool; a bfloat16
    model folds where a float32 one does, and its folded stage runs in
    kernel B's bfloat16 version, as the JAX model folds in either type.
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
    device_graph: bool = False

    def __post_init__(self):
        if self.flow not in ("source_to_target", "target_to_source"):
            raise ValueError(f"invalid flow: {self.flow}")
        if self.variant not in ("full", "s"):
            raise ValueError(f"invalid variant: {self.variant}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r}: the port computes in "
                "float32 or bfloat16"
            )

    def folds(self) -> bool:
        """Whether the model folds the sbf MLP through the triplet gather and
        runs the folded stage in kernel B: where ``fold_sbf`` says, else
        wherever that kernel is built for ``(num_spherical, dim)``."""
        if self.fold_sbf is not None:
            return self.fold_sbf
        return (self.num_spherical, self.dim) in KERNEL_SHAPES

    @property
    def dtype(self) -> torch.dtype:
        """``compute_dtype`` as a torch dtype."""
        return getattr(torch, self.compute_dtype)

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
    models.py:32), otherwise H/C/N/O/F.  PDBbind holds the parameter too
    (reference: models.py:58-60) but reads features through ``init_linear``
    and never the embedding (``embeds_atom_types``)."""
    return 3 if dataset_kind == "rna" else 5


def embeds_atom_types(dataset_kind: str) -> bool:
    """Whether the forward gathers the atom-type embedding by ``z``, so a
    training batch needs the CSR of ``z``: every branch but PDBbind."""
    return dataset_kind != "pdbbind"


def set_matmul_precision() -> None:
    """Products as the JAX package's drivers take them on the card: float32
    GEMMs in full float32 (TF32 off), bfloat16 GEMMs accumulated in float32
    without reduced-precision reductions, as XLA's are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
