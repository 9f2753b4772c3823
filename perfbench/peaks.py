"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense
rates, at the full 700 W power limit); the card's own limit is reported
beside every share."""

FLOAT32_FLOPS = 67e12        # float32 outside the tensor cores, FLOP/s (an FMA is 2)
# one float32 instruction a lane a clock (132 SMs x 128 lanes x 1.98 GHz): the
# rate of adds, subtractions and multiplies, which are one operation each
FLOAT32_OPS_PER_S = FLOAT32_FLOPS / 2
HBM_BYTES_PER_S = 3.35e12    # HBM3, bytes/s
