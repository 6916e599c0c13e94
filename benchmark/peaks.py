"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the yardstick of
every ``mfu`` and ``roofline`` metric.  A card set below 700 W runs under
them; the run reports its card's ``power.limit`` beside them."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,  # tensor cores, bf16 and fp16
    "float32": 67e12,  # outside the tensor cores (TF32 off)
}
