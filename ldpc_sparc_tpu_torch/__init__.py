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
  parallel/  the SPARC and concatenated Monte Carlos and the LDPC waterfall
             campaign, on one device or over the 'dp' axis of a
             torch.distributed mesh (`mesh.py`); the section-sharded AMP step
             over its 'sec' axis (`sharded.py`); a multi-process launcher
             (`multiproc_mc.py`)
  io/        the resumable JSONL results store, record helpers and figures
  native/    the float64 C++ BP oracle and the native tools (g++, ctypes)
  utils/     bit codecs, generator derivation, error metrics, profiling
  cli.py     `python -m ldpc_sparc_tpu_torch.cli sparc-sweep | ldpc-campaign |
             concat-sweep | results2csv | plot-results`
  parity.py  carries a JAX-built design into the port

Every module of the JAX package is ported but `utils/compile_cache.py`
(JAX's compilation cache has no counterpart here): the SPARC AMP decode of
every family (plain, power-allocated, spatially coupled), real or complex,
unmodulated or K-PSK, with the SRHT design or, for complex plain codes, the
DFT design; state evolution; LDPC BP, the code library and its oracle;
the AMP <-> BP bridges and the concatenated codec; the Monte Carlos, the
mesh and the section-sharded step; every CLI subcommand and figure.
"""

from .config import (SparcParams, DecodeParams, LdpcParams, ConcatLengths,
                     param_calc, param_calc_semi_protected)
from .ops.transforms import SparcDesign, DesignStack, DftDesign
from .ops.bp import bp_decode
from .models.sparc import sparc_sim, amp_decode, awgn_channel
from .models.state_evolution import sparc_se
from .models.ldpc import LdpcCode, get_code
from .models.concat import ConcatCodec, DECODERS, concat_sim
from .parallel.montecarlo import (concat_ber_point, concat_mc_counts,
                                  concat_mc_trial_errors, ldpc_waterfall_campaign,
                                  sparc_ber_sweep, sparc_mc_counts)

__version__ = "0.1.0"
