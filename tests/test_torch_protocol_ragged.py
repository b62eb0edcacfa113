"""The port's prover stages against JAX `build_proof_stages` on a small
`ragged_mix` circuit: mixed-width constraints, pad slots and a scattered
copy permutation, the arithmetization paths a uniform circuit never takes.
Each stage gets the JAX stage's own inputs (`torch_stage_check.py`).
Tolerance: exact equality (integer field arithmetic, canonical outputs).
"""

import torch

from stark_tpu_torch.r1cs.synth import ragged_mix
from torch_stage_check import check_stages_match_jax

torch.set_num_threads(2)


def test_stages_match_jax_ragged():
    r1cs, witness = ragged_mix(6, seed=3)
    widths = {max(f.n_coefficient for f in c.factors) for c in r1cs.constraints}
    assert len(widths) > 1  # genuinely ragged
    check_stages_match_jax(r1cs, witness)
