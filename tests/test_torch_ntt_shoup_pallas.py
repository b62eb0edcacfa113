"""The port's fused run of Shoup stages (`ops/ntt.py
butterfly_fused_shoup_plain`, the plain version of `csrc/ntt.cu`'s
`butterfly_fused_shoup`) against the TPU kernel itself,
`stark_tpu/ops/pallas_field.py:518 butterfly_fused` with `shoup=True`
(its body `:483 _fused_kernel`), run in interpret mode on the CPU.

One DIF block of 8 (three stages, l = 4, 2, 1) on lazy inputs in [0, 2p)
with 0, 1, R mod p, p - 1, p and 2p - 1 among them, on BN254's scalar
field: the lazy outputs match value for value. The kernel's twiddle rows
come from the JAX package's own `_shoup_stage_tables` and
`make_fused_rows`, the port's from `shoup_stage_tables` and
`pack_shoup_words`. (Interpret mode costs about 5 s a stage; the DIT
direction and `canon` are held against the TPU's arithmetic in
`test_torch_ntt_shoup_jax.py`.) Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import torch

from stark_tpu.ops import ntt as jntt
from stark_tpu.ops import pallas_field as pf
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import ntt
from test_torch_ntt_shoup import FIELDS, _lazy_ints, _raw

torch.set_num_threads(2)

N = 8


def test_fused_dif_equals_the_tpu_kernel():
    field, jfield = FIELDS["bn254"]
    root = field.root_of_unity(N)
    a = _raw(_lazy_ints(field, 17, N))
    ls = ntt.fused_ls(N, "dif")
    tables = ntt.shoup_stage_tables(field, root, N)
    got = ntt.butterfly_fused_shoup_plain(
        field, a, ntt.pack_shoup_words(torch.cat(tables, dim=1)), N, "dif")
    jt = jntt._shoup_stage_tables(jfield, root, N)
    rows = pf.make_fused_rows(jfield, ls, [jt[l.bit_length() - 1] for l in ls], N)
    want = pf.butterfly_fused(jfield, jnp.asarray(planes_to_numpy(a)), rows, ls, N, "dif",
                              shoup=True, canon=False)
    assert np.array_equal(planes_to_numpy(got), np.asarray(want))
