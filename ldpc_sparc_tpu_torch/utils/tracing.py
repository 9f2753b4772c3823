"""The port's spans and counters.

  * `span(name)`: a named range on `torch.profiler`'s host timeline, which
    the profiler aligns with the card's kernels, so that a trace shows what
    the program was doing while the card ran or idled. With no profiler
    recording it is one shared no-op context: the profiler being on is the
    only switch, and a span then costs one flag check.
  * `count(name, n=1)`, `counters()`, `reset(*names)`: process-wide host
    integers. Counting never synchronises the card and launches nothing;
    `n` is a Python int the caller already holds.

Spans (`parallel/montecarlo.py::sparc_mc_counts`, one point):

    mc.designs   each wait for a design drawn on the host     n_designs
                 thread, and its upload (main thread)
    mc.bits      each design's trial generators and bits      n_designs
    mc.encode    each design's encode, A beta0                n_designs
    mc.noise     each design's AWGN draws                     n_designs
    mc.decode    each design's `decode_batch`                 n_designs
    mc.count     each design's error counts, and the read     n_designs + 1

The concatenated point (`parallel/montecarlo.py::concat_mc_counts`) takes
each `mc.*` span once: the designs' build, upload and per-trial gather;
the bits; the LDPC encode and A beta0; the noise; the one `decode_soft`;
the counts and the one read. Inside its decode (`models/concat.py`):

    concat.amp       each AMP step: the two products, the residual, the
                     Onsager term                             t_max
    concat.eta       the integrated decoder's denoiser: MMSE, bits, inner
                     BP, sections, the Onsager derivative     t_max - 1
    concat.bp_final  the last step's MMSE, bits and hard BP   1

The LDPC waterfall campaign (`parallel/montecarlo.py::
ldpc_waterfall_campaign`, through `_batch_counts`) takes the `mc.*` spans
once a batch, the speculative batch included:

    mc.bits         the batch's information bits
    mc.noise        its AWGN draws
    mc.encode       the LDPC encode, BPSK and the channel LLRs
    mc.decode       the batched BP decode (K4 on a card)
    mc.count        the bit and block errors and the iteration sum
    campaign.read   the host's wait for a batch's counts and their read
                    (the event and the pinned copy when pipelined; the
                    copy of `_ldpc_block_counts` when serial)

Counters:

    mc.designs_built    designs the host thread drew and `sparc_mc_counts`
                        took, n_designs a point
    mc.designs_waited   of those, the ones not yet drawn when the point
                        asked for them (the first design of a point always)
    amp.row_iters       rows each AMP iteration computes (`amp_decode`)
    amp.live_row_iters  of those, the rows still running: the sum of the
                        decodes' t_final (`sparc_mc_counts`)
    concat.iters        steps of the integrated decoder's loop, the last
                        one included: t_max a decode
    concat.decodes      integrated decodes (one `decode_soft` call each)
    concat.bp_codeword_iters  BP iterations of every codeword of the
                        point's decodes, from the `bp_iters` that
                        `concat_mc_counts` reads back (this rank's rows)
    campaign.points     points the campaign measured
    campaign.batches    batches dispatched, the pipelined loop's
                        speculative one of each point included
    campaign.batches_discarded  of those, the speculative batches a
                        pipelined point discarded: one a point
    campaign.codeword_iters  BP iterations of every codeword of the counted
                        batches, from the counts the loop reads anyway
    k1.launches .. k4.launches   launches of the hand-written kernels
                        (`ops/wht_cuda.py` K1 and K2, `ops/denoiser_cuda.py`
                        K3, `ops/bp_cuda.py` K4)
    k3.freeze_launches  of K3's launches, those that took the AMP loop's
                        `stopped` mask (`ops/denoiser_cuda.py`): every
                        launch of a fused `amp_decode`; the rows they
                        copied through are amp.row_iters - amp.live_row_iters
    k1.block_products   of K1's launches, the design products that took the
                        block-indexed route (`ops/wht_cuda.py`): the window
                        side selected or summed by block index, one a
                        product (an SC decode of t_max 40 counts 77)
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

_OFF = contextlib.nullcontext()
_COUNTS: Counter = Counter()


def span(name: str):
    """`with span("mc.decode"): ...` marks the block on the profiler's
    timeline while a profiler records; else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add host integer `n` to counter `name`."""
    _COUNTS[name] += n


def counters() -> Counter:
    """A copy of every counter (a name never counted reads 0)."""
    return Counter(_COUNTS)


def reset(*names: str) -> None:
    """Zero the counters `names`, or every counter when none is named."""
    if not names:
        _COUNTS.clear()
    for name in names:
        _COUNTS.pop(name, None)
