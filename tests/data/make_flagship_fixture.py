"""Write the full-shape fixtures that hold the port's kernels to the JAX
package: run on a CPU, with JAX, from the repository's root:

    JAX_PLATFORMS=cpu python tests/data/make_flagship_fixture.py [amp] [concat]

Two decodes of the JAX package at shapes the CPU tests cannot afford, 4
codewords each, inputs made with numpy from the seeds written beside them:

* `amp`: the plain SPARC of `bench.py`'s headline (L=1024, M=512, R=1.0,
  P=15, awgn_var 1, t_max 25, design seed 0). y = A beta0 + noise with the
  JAX design's float32 product. Written: y, the decided section indices and
  t_final.
* `concat`: the z=150 concatenated point (802.16 r=1/2, mults=4, M=2,
  L=14,400, P=19.44, R=1.0, t_max=25, awgn_var = P / 3.8), decoder
  `integrated`, designs ((3, 0), d) for trial d as the Monte Carlo seeds
  them. Written: the user bits and y, the decided user bits and the
  per-trial error counts.

The designs are not written: the port builds bit-identical ones from the
same seeds (tests/test_torch_transforms.py). Arrays go to `.npy` files next
to this script (bits packed with `np.packbits`), the rest to
`flagship.json`. The card tests of tests/test_torch_kernels.py decode the
same y through K1+K3 and K1+K4 and compare.

`make_amp` and `make_concat` write nothing: each returns (the record for
`flagship.json`, {file stem: array}), so tests/test_torch_flagship.py can
run them and hold the committed files to what they return.
"""

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))   # the repository's root
N_CODEWORDS = 4
AMP = dict(P=15.0, R=1.0, L=1024, M=512, awgn_var=1.0, t_max=25, design_seed=0,
           input_seed=11)
CONCAT = dict(standard="802.16", rate="1/2", z=150, mults=4, logM=1, P=19.44,
              R_sparc=1.0, t_max=25, snr=3.8, seed=[3, 0], decoder="integrated",
              input_seed=12)


def make_amp():
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import DecodeParams, SparcParams
    from ldpc_sparc_tpu.models.sparc import amp_decode
    from ldpc_sparc_tpu.ops.transforms import SparcDesign
    from ldpc_sparc_tpu.utils import bits as bitops

    c = AMP
    params = SparcParams(P=c["P"], R=c["R"], L=c["L"], M=c["M"])
    design = SparcDesign.for_params(params, c["awgn_var"], c["design_seed"])
    rng = np.random.default_rng(c["input_seed"])
    bits = rng.integers(0, 2, (N_CODEWORDS, params.bit_len)).astype(bool)
    noise = rng.normal(size=(N_CODEWORDS, design.n)).astype(np.float32)
    beta0 = jnp.stack([bitops.bits_to_msg_vector(jnp.asarray(b), params.M) for b in bits])
    y = (np.asarray(design.ab(beta0)) + np.sqrt(np.float32(c["awgn_var"])) * noise
         ).astype(np.float32)
    res = jax.jit(jax.vmap(lambda yy: amp_decode(
        yy, design, params, DecodeParams(t_max=c["t_max"]), c["awgn_var"])))(jnp.asarray(y))
    sections = np.asarray(res.beta).reshape(N_CODEWORDS, params.L, params.M).argmax(-1)
    sent = np.asarray(beta0).reshape(N_CODEWORDS, params.L, params.M).argmax(-1)
    meta = {**c, "n": int(design.n), "t_final": np.asarray(res.t_final).tolist(),
            "section_errors": (sections != sent).sum(-1).tolist()}
    return meta, {"flagship_amp_y": y, "flagship_amp_sections": sections.astype(np.int16)}


def make_concat():
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import DecodeParams, LdpcParams, SparcParams, param_calc
    from ldpc_sparc_tpu.models.concat import ConcatCodec
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.utils import bits as bitops

    c = CONCAT
    ldpc = LdpcParams(standard=c["standard"], rate=c["rate"], z=c["z"])
    K = get_code(c["standard"], c["rate"], c["z"]).K
    _, _, L, lengths = param_calc(c["mults"], c["logM"], ldpc, ldpc.rate_float,
                                  c["R_sparc"], K)
    sp = SparcParams(P=c["P"], R=c["R_sparc"], L=L, M=2 ** c["logM"])
    codec = ConcatCodec(sp, ldpc, lengths, True)
    designs = [codec.build_design((tuple(c["seed"]), d)) for d in range(N_CODEWORDS)]
    stack = designs[0].with_leaves(jnp.stack([d.idx for d in designs]),
                                   jnp.stack([d.signs for d in designs]))
    rng = np.random.default_rng(c["input_seed"])
    user_bits = rng.integers(0, 2, (N_CODEWORDS, codec.user_bits_len)).astype(np.int32)
    noise = rng.normal(size=(N_CODEWORDS, codec.n)).astype(np.float32)
    xs = []
    for d, u in zip(designs, user_bits):
        total = codec.encode_ldpc_bits(jnp.asarray(u))
        beta0 = bitops.bits_to_msg_vector(total.astype(bool), sp.M, 1,
                                          amplitude=codec.c_amp)
        xs.append(np.asarray(d.ab(beta0 / codec.c_amp)))
    y = (np.stack(xs) + np.sqrt(np.float32(c["P"] / c["snr"])) * noise).astype(np.float32)
    bits_out = np.asarray(jax.jit(lambda ys, i, g: codec.decode_batch(
        ys, stack.with_leaves(i, g), DecodeParams(t_max=c["t_max"]), c["decoder"]))(
            jnp.asarray(y), stack.idx, stack.signs))
    meta = {**c, "L": int(L), "n": int(codec.n), "user_bits_len": int(codec.user_bits_len),
            "errors": (bits_out != user_bits).sum(-1).tolist()}
    return meta, {"flagship_concat_y": y,
                  "flagship_concat_user_bits": np.packbits(user_bits.astype(bool), -1),
                  "flagship_concat_bits_out": np.packbits(bits_out.astype(bool), -1)}


MAKERS = {"amp": make_amp, "concat": make_concat}


def main(argv):
    which = argv or ["amp", "concat"]
    path = HERE / "flagship.json"
    out = json.loads(path.read_text()) if path.exists() else {}
    out["n_codewords"] = N_CODEWORDS
    for name in which:
        out[name], arrays = MAKERS[name]()
        for stem, a in arrays.items():
            np.save(HERE / f"{stem}.npy", a)
        print(name, json.dumps(out[name]), flush=True)
    path.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
