"""ldpc_sparc_tpu_torch: the PyTorch / CUDA port of ldpc_sparc_tpu.

The JAX package `ldpc_sparc_tpu` is the reference this port is held
against; the two share no code, and this package imports neither JAX nor
`ldpc_sparc_tpu`. Its layout mirrors the reference's:

  config.py  typed SPARC and LDPC parameters, base matrices (numpy)
  ops/       design transforms, denoisers, LDPC belief propagation, and the
             hand-written Hopper kernels with their plain PyTorch versions
             (`*_cuda.py`, sources in `csrc/`, built by `_build.py` at
             first use)
  models/    the SPARC codec and AMP decoder; state evolution; the
             802.11n / 802.16 LDPC code library; the concatenated
             LDPC-SPARC codec with its eight decoders
  parallel/  the single-device SPARC and concatenated Monte Carlos and the
             LDPC waterfall campaign
  io/        the resumable JSONL results store and record helpers
  utils/     bit codecs, generator derivation, error metrics
  cli.py     `python -m ldpc_sparc_tpu_torch.cli sparc-sweep | concat-sweep`
  parity.py  carries a JAX-built design into the port

Ported so far: the SPARC AMP decode of every family (plain,
power-allocated, spatially coupled), real or complex, unmodulated or K-PSK,
with the SRHT design or, for complex plain codes, the DFT design; state
evolution, the SPARC Monte Carlo and its sweep CLI; LDPC BP, the code library and the waterfall
campaign; the AMP <-> BP bridges, the concatenated codec, its Monte Carlo
and `concat-sweep`.
"""

from .config import (SparcParams, DecodeParams, LdpcParams, ConcatLengths,
                     param_calc, param_calc_semi_protected)
from .ops.transforms import SparcDesign, DesignStack, DftDesign
from .ops.bp import bp_decode
from .models.sparc import sparc_sim, amp_decode, awgn_channel
from .models.state_evolution import sparc_se
from .models.ldpc import LdpcCode, get_code
from .models.concat import ConcatCodec, DECODERS, concat_sim
from .parallel.montecarlo import (concat_ber_point, concat_mc_trial_errors,
                                  ldpc_waterfall_campaign, sparc_ber_sweep,
                                  sparc_mc_counts)

__version__ = "0.1.0"
