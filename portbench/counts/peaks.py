"""Published peaks of the cards a run may name (NVIDIA's data sheets,
dense rates without sparsity), keyed by ``torch.cuda.get_device_name()``.
A card not listed gets no roofline or ``mfu`` reading."""
from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    # H100 SXM5: 67 TFLOP/s fp32 outside the tensor cores, 495 TF32,
    # 989 bf16, 3.35 TB/s HBM3; at the 700 W limit
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "tf32_flops": 495e12,
                              "bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def lookup(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)
