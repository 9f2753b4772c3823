"""K3's cluster route (csrc/denoise_update.cu, `denoise_update_cluster_kernel`)
emulated in plain torch on the CPU, where no card runs the kernel.

From M = 2^16 a thread-block cluster of C blocks owns a section
(`denoiser_cuda.cluster_layout`: C = M / 2^14 up to 2^18, 16 above), block c
the contiguous share [c M / C, (c + 1) M / C). Each of its 1024 threads
sums its float4 pieces t + 1024 j in turn, the block reduces the threads'
partials by warp shuffles (a butterfly over lanes, then over warps), and the
C block partials of the section's max, sum of exps and energy are combined
in block-rank order. The emulation below does the same in float32, in the
same order. The per-entry operations are the plain version's (s = beta +
tau azo rounded twice, s / tau, exp, e / z), so s is bit-equal to
`fused_denoise_update_ref`, and beta_new and the energies are held at the
tolerances chip_smoke.py's phase 21 states (rtol 1e-5, atol 1e-12, far
below a softmax entry of 2^20). On the card tests/test_torch_kernels.py
holds the kernel itself to the same bounds.
"""

import pytest
import torch

from ldpc_sparc_tpu_torch.ops import denoiser_cuda

THREADS, LANES = 1024, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _butterfly(v, op):
    """The kernel's `block_allreduce` over the last axis (1024 threads):
    shfl_xor 16, 8, 4, 2, 1 within each warp, then the same over the 32
    warps' lane-0 values."""
    idx = torch.arange(LANES)
    v = v.reshape(*v.shape[:-1], THREADS // LANES, LANES)
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., idx ^ o])
    v = v[..., 0]
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., idx ^ o])
    return v[..., 0]


def _thread_sums(x):
    """Each thread's partial of x (..., share): pieces of 4 entries, piece
    t + 1024 j to thread t, summed in turn as z += ((x + y) + z) + w."""
    p = x.reshape(*x.shape[:-1], -1, THREADS, 4)
    piece = ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]
    acc = torch.zeros_like(piece[..., 0, :])
    for j in range(piece.shape[-2]):
        acc = acc + piece[..., j, :]
    return acc


def _combine(part, op):
    """The C block partials (..., C) in rank order."""
    r = part[..., 0]
    for k in range(1, part.shape[-1]):
        r = op(r, part[..., k])
    return r


def emulate_cluster_route(beta, azo, tau_sec, M, C=None):
    """s, beta_new, sec_en as the cluster route computes them, with the
    kernel's C blocks a section (`cluster_layout`) or the C given."""
    C = C or denoiser_cuda.cluster_layout(M)[0]
    share = M // C
    assert share % (4 * THREADS) == 0
    shape = beta.shape
    t = tau_sec[..., None, None]
    view = tau_sec.shape + (C, share)
    s = beta.reshape(view) + t * azo.reshape(view)
    v = s / t
    # the max: each thread's, the block's, the cluster's
    m = _combine(_butterfly(v.reshape(*view[:-1], -1, THREADS, 4).amax(-1).amax(-2),
                            torch.maximum), torch.maximum)[..., None, None]
    # the held entries and the re-read ones give the same exps: the kernel
    # computes exp(s / tau - m) for both
    e = torch.exp(v - m)
    z = _combine(_butterfly(_thread_sums(e), torch.add), torch.add)[..., None, None]
    p = e / z
    en = _combine(_butterfly(_thread_sums(p * p), torch.add), torch.add)
    return s.reshape(shape), p.reshape(shape), en


def _inputs(B, L, M, seed):
    gen = torch.Generator().manual_seed(seed)
    beta = torch.softmax(3 * torch.randn(B, L, M, generator=gen), -1).reshape(B, L * M)
    azo = 2 * torch.randn(B, L * M, generator=gen)
    tau = 0.5 + 1.5 * torch.rand(B, L, generator=gen)
    return beta, azo, tau


# (M, B, L, C): the kernel's layouts (C = 4 and 16 with shares of 2^14, 16
# with shares of 2^15, and of 2^16 with half of each re-read), and the split
# at C = 2, 4 and 16 on one section length
CASES = [(1 << 16, 2, 3, None), (1 << 18, 1, 2, None), (1 << 19, 1, 2, None),
         (1 << 20, 1, 1, None), (1 << 17, 1, 3, 2), (1 << 17, 1, 3, 4), (1 << 17, 1, 3, 16)]


@pytest.mark.parametrize("M,B,L,C", CASES, ids=lambda v: str(v))
def test_split_reductions_match_the_plain_version(M, B, L, C):
    beta, azo, tau = _inputs(B, L, M, M)
    got = emulate_cluster_route(beta, azo, tau, M, C)
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)
    assert torch.isfinite(got[1]).all() and got[2].shape == (B, L)


def test_rank_order_gives_one_answer():
    """Every block of a cluster combines the same partials in the same order,
    so all get the same bits; another order may not."""
    gen = torch.Generator().manual_seed(0)
    part = torch.rand(4096, 16, generator=gen) * torch.logspace(-6, 0, 16)
    a = _combine(part, torch.add)
    assert torch.equal(a, _combine(part.clone(), torch.add))
    b = _combine(part.flip(-1), torch.add)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_cluster_layout_and_routes():
    assert [denoiser_cuda.cluster_layout(1 << k) for k in range(16, 23)] == [
        (4, 1 << 14, 1 << 14), (8, 1 << 14, 1 << 14), (16, 1 << 14, 1 << 14),
        (16, 1 << 15, 1 << 15), (16, 1 << 16, 1 << 15), (16, 1 << 17, 1 << 15),
        (16, 1 << 18, 1 << 15)]
    for M in (1 << 15, 1 << 23, 3 << 16):
        with pytest.raises(ValueError):
            denoiser_cuda.cluster_layout(M)
    assert [denoiser_cuda.k3_route(1 << k) for k in (5, 12, 13, 15, 16, 20, 22)] == [
        "block"] * 4 + ["cluster"] * 3
    # the fused tail's shapes do not change with the new route
    assert all(denoiser_cuda.fused_eligible(1 << k, 1, False) for k in range(5, 23))
    assert not any(denoiser_cuda.fused_eligible(m, 1, False) for m in (16, 1 << 23, 96))


def test_the_wrapper_checks_the_route_before_the_device():
    beta, azo, tau = _inputs(1, 2, 1 << 13, 0)
    with pytest.raises(ValueError, match="cluster route"):
        denoiser_cuda.fused_denoise_update(beta, azo, tau, 1 << 13, "cluster")
    with pytest.raises(ValueError, match="route must be"):
        denoiser_cuda.fused_denoise_update(beta, azo, tau, 1 << 13, "registers")
    # on the CPU every route is the plain version
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, 1 << 13)
    for route in (None, "block"):
        got = denoiser_cuda.fused_denoise_update(beta, azo, tau, 1 << 13, route)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
