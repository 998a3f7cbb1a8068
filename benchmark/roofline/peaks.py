"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline share and
of the whole forward's mfu. A run states the card's power limit beside
them."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bf16": 989e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "f32": 67e12,  # outside the tensor cores
}
