#!/usr/bin/env python3
"""Prove and verify R1CS circuits with the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line with its seconds; any failure exits
non-zero and no phase's error is swallowed:

1. device: a CUDA card must be present (its name and power limit are
   printed as `nvidia-smi --query-gpu=name,power.limit` gives them);
2. build: the kernel library is built with nvcc from stark_tpu_torch/csrc;
   the record's `ptxas` list holds what `ptxas -v` said of every kernel
   (registers, spills), the ones redesigned for Hopper among them;
3. kernels: each of the 29 CUDA kernels (the 22 TPU kernels' counterparts,
   the multi-stage pass, the Shoup-twiddle forms of the pass and of the
   fused pass, the vanishing product's pre-pass, the Poseidon pair,
   `poseidon_leaves` and `poseidon_pairs`, and FRI's default fold round,
   `fri_fold_dft`) against its plain PyTorch version
   on the card, at the prover's shapes for 43,690 constraints (steps 2^17,
   precision 2^20), inputs from a numpy seed; tolerance: exact equality
   (integer field arithmetic with canonical outputs), with the median
   device time of both per case (a sleep kernel ahead of each timed call
   keeps the host's launch work out of it) and the least time the card
   could take (`bound_ms`), its share of the kernel's time (`bound_share`) and, where the operations
   are of one kind, the rate achieved (`achieved_ops_per_s`: int8 operations
   a second for `matmul_fold`). `butterfly_stage` runs the plan's single
   stages (9 at 2^20, 6 at 2^17), which `butterfly_pass` now runs in passes
   of three: the pass runs every pass of both plans (the 2^20 transform's
   last, which reads the widest table, first), one of each on columns with
   0, 1, Montgomery one and p - 1, short passes of two stages and one, and
   BLS12-381's scalar field (the canonical build) at every pass of both
   directions at 2^17; its bytes count the column in and out and the table
   it reads. `butterfly_fused` runs dit and dif at 2^20
   and dif at 2^17, the three shapes the LDE gives it, then its canonical
   build on BLS12-381's scalar field (dit and dif at 2^17 and at one block
   of 2048); beside its bound, which counts a product a butterfly,
   `bound_needed_ms` leaves out the products by a twiddle equal to
   Montgomery one, which the kernel skips. The Shoup forms
   (`compare_shoup`: plain twiddles with their companions, values in
   [0, 2p), a DIT plan's last stage below p): `butterfly_pass_shoup` at
   every pass of the 2^20 and 2^17 Shoup plans, their widest and first on
   `lazy_planes`' 0, 1, Montgomery one, p - 1, p and 2p - 1, and every pass
   of both directions on BLS12-381's field at 2^17;
   `butterfly_fused_shoup` dit and dif at 2^20 (block 2048), dif and dit at
   2^17, the 2^20 ones on the edge values reducing below p, BLS12-381's at
   2^17 and one block, and both fields' dit (reducing below p) and dif at
   2^15 in blocks of 2 (one CTA a block), 4 (the smallest cluster), 16 and
   1024. `mpow_scalar` runs e = p - 2 at
   (16, 1) and (16, 8) and on BLS12-381's field, e = 0, 1, 2^256 - 1 on edge
   operands, and e = 2^255, 2^127 for the time of one dependent squaring.
   The three kernels of the CRT LDE engine run on that engine's own tables
   for this size (their host build, or their load from the disk cache, is
   timed), at the four products of one LDE and at small ragged shapes.
   `scan_prod` runs at the levels of `modmath.scan_levels` for both sizes
   and at two fixed shapes, (16, 64, 2^11) and (16, 64, 2^14), with the
   team (`field_cuda.scan_team`) of each case. The fold pair runs at every
   round's quarter q (2^18 down to 2^6), at q = 192 and on BLS12-381's
   field at 2^16, each case with 0, 1 and p - 1 among the x and y, a row
   with two equal x and sx equal to one of a row's x (`fold_inputs`).
   `fri_fold_dft` runs at the rounds of a 2^23 prove (`fold_dft_cases`:
   q = 2^21, 2^19 and 2^17, the whole domain's table read at strides 1, 4
   and 16, and the last three rounds' 2^9, 2^7 and 2^5), its root words
   random, all ones and zero, and on BLS12-381's field at q = 2^16.
   `q2_eval` runs the prover's shift (in `fused_kernels.q2_plan`'s grouped
   order), shifts 0, 1 and n - 1 and the 2^17 domain's prover shape;
   `linear_combination_shoup` a pattern of 8 and of 1,024 columns, every
   k_j p - 1 with every plane through `with_edges`, and BLS12-381's field
   at 2^16. `horner_eval` and `vanishing_eval` run at counts on each side
   of their groups (`compare_groups`), up to the `bits` golden's 1,062
   public wires (compared at 2^14, timed alone at 2^20), with each case's
   group and product floor (`floor_ms`); their pre-pass,
   `vanishing_coeffs`, at 1,062 and 17 points. The Poseidon pair at the
   l-tree's leaf layer (2^20 leaves) and a fold level of 2^19 pairs, then at
   2^17, 1, 3, 33, 2^10 and 2^13 hashes and on both sides of the wrapper's
   width constant (`poseidon.LANE_FORM_BELOW`: a group of 4 lanes a hash
   below it, a thread a hash at it; each case names its form), with 0, 1,
   BN254's r - 1 and BLS12-381's p - 1 among the inputs
   (`compare_poseidon`), each level of a 2^20 tree timed alone (`levels`,
   the narrow ones beside a latency model, `model_ms`) and `ptxas -v`'s
   registers, stack and spills of its four builds.
   After each kernel's own cases, those of the big-domain phase's shapes
   (precision 2^23, steps 2^20; `big_domain_cases`, labels "big domain
   ..."): every `butterfly_pass` of the LDE's two transforms (the 2^23
   transform's 4 passes, which read the widest tables, and the inverse's
   3), `butterfly_fused` on both, `scan_prod` at each level of
   `multi_inv`'s 2^23 scans, and the m-tree's:
   `from_mont_pack_words` of a column into 8 rows of the (64, 2^23) leaf
   words, `blake2s_words` over them and over the first node layer above
   them; each `torch.equal` to its plain version, with its device time
   and bound. Then, in a record of its own (`prefix_prod`), `prefix_prod` forward and
   reversed and `multi_inv` at 2^17, 2^20 and at lengths 80, 96 and 160:
   each equal (`torch.equal`) to the same function on CPU tensors, with its
   device time and launches;
4. goldens: the `compute` and `poseidon3_test` proofs, on both of FRI's fold
   routes and on the CRT LDE engine (verified on that engine too), and the
   `bits` and `pedersen_test` proofs on both fold routes (`GOLDENS`), must
   be byte-identical to the committed goldens and the `ragged_mix(120)`
   proof must match its committed sha256; the port's verifier must accept
   each. The `bits` golden's first prove (its 1,062 public wires make the
   boundary polynomials long) is run with every launch counter set to 0
   just before and read just after, and with the device time of each call
   of `horner_eval` and `vanishing_eval` in it (`kernels_ms`);
   `vanishing_coeffs`, which the real-size circuit's two public wires do
   not need, must launch there. The `compute` proof under digest="poseidon"
   on both fold routes must equal its committed golden
   (`compute_proof_poseidon_golden.json`) and verify, and the blake2s
   verifier must reject it. Every prove of this phase and of phase 5 must
   launch `fri_fold_dft` once a round of its FRI on the default route and
   never on the Lagrange route (`check_fold_launches`);
5. real size: `squaring_chain(43690)` proved twice (cold and warm) on the
   default route (the radix-4 inverse-DFT fold) and verified; the launch
   counter of every kernel of that route must be > 0 for the cold proving
   run, and the warm run's counts are recorded, with the proof's sha256
   (`proof_sha256`, to hold one build's proof against another's). Then, in
   its own record (`real_size_poseidon`), the same under digest="poseidon"
   (the l-tree and FRI's trees on the Poseidon pair, which must launch),
   with the device time of every Poseidon launch of the warm prove
   (`poseidon_ms`, with how many ran the lane form); its verifier walks
   every branch with the host hash;
5b. file_route: the native file route (`protocol/runner.py`: the C++
   readers of the host library, which must have built, hand the prover the
   flat circuit and the witness rows). The same circuit written as files
   (`synth.write_circuit_files`) is proved by the CLI's `prove`, with every
   launch counter set to 0 just before and read just after (every kernel of
   the default route must launch), and verified by its `verify`; its `run`
   proves and verifies again. Then both routes stage by stage (native,
   and the Python readers the route took before), in turns: each stage's
   host wall (parse of each file, the witness rows, the static
   arithmetization, the prove, the JSON write). Then, each in a fresh
   process, `python -m stark_tpu_torch.cli warmup` and `... prove`, with
   their walls. Every proof must equal phase 5's byte for byte;
5c. tracing: the program's phases (`utils/tracing.py`) on the same
   circuit and route: three warm proves with tracing off, two under
   `trace` alone, two under `trace` and `sync_phases` (their top-level
   phases' walls, which must hold at least 1 - `TRACED_OUTSIDE` of the
   synced prove's wall, and the report's lines), one inside a top-level
   span under `profile_dir` and `sync_phases`, whose Chrome trace
   `utils/profiling.py parse_device_trace` reads (device ms a phase, which
   with `(outside phases)` must sum to the busy time, the busy share of the
   profiled and of the warm prove, the hand-written kernels' share of the
   busy time), the stage set's `resident_bytes()`, and one prove under
   `profiling.phase_memory_peaks` (the peak device bytes a phase). Every
   proof must equal phase 5's byte for byte, and no traced prove may call
   `torch.cuda.reset_peak_memory_stats`;
6. serve: the proving worker (`stark_tpu_torch.serve.serve`, the loop behind
   `python -m stark_tpu_torch.cli serve --device cuda --fri-fold lagrange`)
   on the Lagrange fold route, fed the same circuit as files: ping, warmup,
   two proves, a Poseidon prove, two Poseidon verifies and a blake2s one,
   an unknown method (answered as an error, the worker alive) and shutdown.
   Every launch counter is set to 0 just before and read just after, and
   between requests: each prove must launch `fri_fold_pre` and
   `fri_fold_post`, every kernel of the route must launch, and the proofs
   must equal phase 5's byte for byte. The circuit's first verify must
   launch the LDE's kernels (its 6 public columns), the two after it none
   (`verify_lde_launches`: the columns' LDEs kept on the worker's cached
   circuit); every verify's wall is recorded. Then
   `runner.prove_many` pipelines four witnesses of the circuit (depth 2) on
   the same route: each proof must equal a single prove's, and the seconds
   and proofs per second of both ways are recorded with the peak memory;
7. crt: the same circuit proved cold and warm with `lde_engine="crt"`, all
   9 LDEs on the CRT matrix-product engine: the proof must equal phase 5's
   byte for byte and pass the verifier on that engine; `residues_in`,
   `matmul_fold` and `reconstruct` must each launch in the cold run, and the
   warm run's counts are recorded. A worker started on that engine
   (`serve.serve(..., lde_engine="crt")`) answers a warmup and one prove
   with the same bytes. Then the 9-column `lde_many` stage of both engines
   on the same random traces, in turns: equal outputs, synced wall and
   device time of each. Then, in its own record (`shoup_lde`), the
   9-column LDE of the same shape on the default plan and on the Shoup plan
   (`ntt.make_lde_plan(shoup=True)`), in turns: equal outputs
   (`torch.equal`), each run's device time, and the Shoup kernels'
   launches, which no entry point runs (their `path`);
8. only with `--profile` (run inside phases 5 and 7): for each fold route, for the CRT engine and
   under digest="poseidon" (on the default route), `torch.profiler` over
   one more warm prove (device busy share, launches,
   copies, device time by kernel) and the wall and peak memory of each
   of the program's top-level phases, synced (`stage_walls`);
9. big_domain, after phase 7: `squaring_chain(349525)` (steps 2^20,
   precision 2^23, `core.MAX_PRECISION`: the largest circuit the protocol
   proves) on the defaults, proved cold and warm: both proofs
   byte-identical (`proof_sha256`), the verifier accepting; every kernel of
   the default route must launch in the cold prove, `fri_fold_dft` once a
   round (9); each prove's wall, launches and peak memory, and the host's
   seconds (synthesis, arithmetization). Then (`fold_routes`) the same
   proof on the Lagrange route, and `squaring_chain(174762)` (precision
   2^22) under digest="poseidon" on both routes (8 launches of
   `fri_fold_dft` on the default one): each pair byte-identical;
10. mesh: `squaring_chain(43690)` proved on a mesh of d = 2 and then d = 4
   ranks (`stark_tpu_torch/parallel/`, `runner.prove_with_witness(mesh=)`),
   each rank an OS process on the one card (`distributed.run_ranks`) over
   gloo, every collective staged through pinned host buffers: NCCL needs a
   card a rank (the record says so beside `torch.cuda.device_count()`;
   where the host has two cards NCCL runs at d = 2 too, else the record
   says "not run"). Each rank proves cold and warm on the defaults, and at
   d = 2 once on the Lagrange fold and once under digest="poseidon"
   (`mesh_rank`). Every rank's proofs must equal phase 5's byte for byte
   (`real_size_poseidon`'s under Poseidon), every kernel of the mesh path
   (`mesh_kernels()`: the default route's but the fused quotients, which
   the mesh computes as the JAX package's mesh form does, rolls and `mmul`
   products) must launch in every rank's cold prove, and rank 0's proof
   must pass the single-device verifier. Each rank's walls, peak memory
   (`max_memory_allocated` in its own process) and its collectives' calls,
   bytes (of the tensors they return) and synced seconds are recorded;
   they measure host-staged gloo on one card, not a multi-card scaling.
   At d = 2 each rank then builds its local DFTs' CRT plans
   (`crt_table_build_s`) and proves cold and warm with `lde_engine="crt"`
   (`crt cold`, `crt warm`): the proofs must equal phase 5's, `residues_in`,
   `matmul_fold` and `reconstruct` must launch in every rank's cold prove,
   and the collectives' bytes of each kind must equal the butterfly
   prove's. At d = 2 and 4, `mxu_ntt.lde_mxu_sharded` of a (16, 2^17)
   column to 2^20 must equal the rank's chunk of `lde_mxu` on one device
   (`torch.equal`), its CRT kernels launched (`mesh_lde_case`).

The line before the card's lists the kernels of the three paths as JSON
(`kernels`; each with the numbers of its first case, the largest shape the
proving run gives it, named under `case`; `launches_big_domain` its
launches in phase 9's cold prove; `launches_mesh` its launches in each
rank's cold prove of phase 10, by d, and under "2, crt" in each rank's
crt cold prove; `path` names the phase whose run
counted its `launches`: `real_size`, `real_size_poseidon` for the
Poseidon pair, `serve` for the two fold kernels,
which the default route does not run, `crt` for the three kernels of
the CRT engine, `shoup_lde` for the two Shoup forms, or `goldens: bits`
for `vanishing_coeffs`) and, under
`off_path`, the two
ported kernels no path runs: `linear_combination` on the (16, n)
x^steps table, whose place the stages' Shoup pattern pair takes, and
`butterfly_stage`, whose place the multi-stage pass takes. The last
line is {"ok": true, "device": {...}}. `--out DIR` also writes every phase
record, with every case, to DIR/chip_smoke.json.

`bound_ms` is the larger of the bytes a kernel must move (each input read
once, each output written once) over 3.35 TB/s and its integer operations
over 16.75e12 a second: an H100 SM executes 64 32-bit integer operations a
clock, half of the 128 FP32 lanes behind the published 67 TFLOP/s. A
Montgomery product counts 136 multiply-adds (two 8x8-word products and 8
for the reduction factors), as does a Shoup product (one 8x8-word product
and two low halves of 36), a Blake2s compression 960 (10 rounds of 8 G of
12), a squaring 108 (its 36 distinct limb products and the reduction's 72);
a Poseidon hash counts the 416 products and 156 squarings of the
permutation's optimized form (412 and 154 for a leaf, whose right input is
0), with sparse partial rounds (`POSEIDON_PAIR_PRODUCTS`). The linear combination counts what the function needs: folded into
three coefficients (k3 + k4 x^steps) and the like, its x^steps terms leave
8 products an element, and 3 a pattern column make the coefficients of
`linear_combination_shoup`; `linear_combination`'s x^steps differs at
every element, so it needs 11 an element.
`bound_by` is "bytes" unless the operations take strictly longer.
`matmul_fold`'s operations are the multiply-adds of its four digit products,
2 * 4 * K * kout * B a prime, over the 1,979e12 a second of the int8 tensor
cores (the `wgmma` s8 instruction it uses). `residues_in` is counted by
what the function needs, not by the instructions its kernel spends: the
(P+1, 32) table times the 32 bytes of a lane is an int8 matrix product, 2 * 32
multiply-adds a prime and lane at that same tensor-core rate (the kernel
forms it with mma.sync, whose rate is below wgmma's, which the bound does
not excuse), and
beside it 7 integer operations a prime and lane (one Barrett step of 5: high
product, product, subtraction, comparison, conditional subtraction; two for
the digits), 6 more with a pre-table (the product and a second step). Where
a function has operations of two kinds, each kind is taken over its own
rate and the larger time counts: the two units run side by side.
`reconstruct` counts 16 integer operations a prime and lane plus 200 for
the reduction.

`mpow_scalar` and `scan_prod` walk chains of dependent products on few
threads, which that bound does not see. Beside it, and not as a bound, they
get `chain_ms`: the chain's length times the critical path of one CIOS
product under a stated model, over the card's highest SM clock as
`nvidia-smi --query-gpu=clocks.max.sm` gives it. The model: each of the 8
rounds hands its lowest word to the next after 4 dependent multiply-adds
(product word 0, the reduction factor, reduction words 0 and 1), the last
round drains 7 more words, and the top word and the conditional subtraction
add 10: 48 dependent 64-bit multiply-adds, each counted as two dependent
integer instructions of 4 cycles. The length is what the function needs,
not what a kernel does: for `scan_prod` one thread's walk, a team sharing
each column (`modmath.scan_chain`); for `mpow_scalar` e.bit_length() - 1
dependent squarings and the one product that must follow the last (254
for BN254's p - 2, where MSB-first square-and-multiply walks 381), since
the multiplies by the powers a^(2^i) can run beside the squarings. No
single PyTorch call computes any of these functions, so `library_ms` is
null, but for `matmul_fold`: there it is
the time of four `torch.bmm` calls on bf16 copies of the same digit planes,
the products only, without the recombination and the fold.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
REAL_CONSTRAINTS = 43690
# the big-domain phase's circuit: the largest squaring chain at precision 2^23
# (steps 2^20), the protocol's largest precision
BIG_CONSTRAINTS = 349525
POSEIDON_BIG_CONSTRAINTS = 174762  # precision 2^22, proved under digest="poseidon"
BIG_PRECISION = 1 << 23
SEED = 20261016

_PK = "stark_tpu/protocol/pallas_kernels.py"
_PROTOCOL_CU = "stark_tpu_torch/csrc/protocol.cu"
_FRI_CU = "stark_tpu_torch/csrc/fri.cu"
_CRT_CU = "stark_tpu_torch/csrc/crt.cu"
_POSEIDON_CU = "stark_tpu_torch/csrc/poseidon.cu"
_POSEIDON_JAX = "stark_tpu/ops/poseidon.py:147"
_FOLD_JAX = "stark_tpu/fri/fri.py:121"
KERNELS = {
    # wrapper name -> (source in the repo, the TPU kernel it replaces)
    "mmul": ("stark_tpu_torch/csrc/mmul.cu", "stark_tpu/ops/pallas_field.py:174"),
    "butterfly_stage": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:446",
    ),
    "butterfly_pass": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:446",
    ),
    "butterfly_fused": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:518",
    ),
    # the Shoup-twiddle forms of the two (shoup=True: the bodies :427 and :483)
    "butterfly_pass_shoup": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:446",
    ),
    "butterfly_fused_shoup": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:518",
    ),
    "blake2s_words": (
        "stark_tpu_torch/csrc/blake2s.cu", "stark_tpu/ops/pallas_blake2s.py:84",
    ),
    "mpow_scalar": (
        "stark_tpu_torch/csrc/fieldops.cu", "stark_tpu/ops/pallas_field.py:573",
    ),
    "scan_prod": (
        "stark_tpu_torch/csrc/fieldops.cu", "stark_tpu/ops/pallas_field.py:626",
    ),
    # the port's own kernel: the JAX package's Poseidon is an XLA lax.scan
    "poseidon_leaves": (_POSEIDON_CU, _POSEIDON_JAX),
    "poseidon_pairs": (_POSEIDON_CU, _POSEIDON_JAX),
    "rand_combination": (_PROTOCOL_CU, f"{_PK}:98"),
    "q1_eval": (_PROTOCOL_CU, f"{_PK}:118"),
    "q2_eval": (_PROTOCOL_CU, f"{_PK}:137"),
    "q3_eval": (_PROTOCOL_CU, f"{_PK}:154"),
    "linear_combination": (_PROTOCOL_CU, f"{_PK}:190"),
    "shoup_mul_periodic": (_PROTOCOL_CU, f"{_PK}:268"),
    "linear_combination_shoup": (_PROTOCOL_CU, f"{_PK}:319"),
    "horner_eval": (_PROTOCOL_CU, f"{_PK}:214"),
    "vanishing_coeffs": (_PROTOCOL_CU, f"{_PK}:236"),
    "vanishing_eval": (_PROTOCOL_CU, f"{_PK}:236"),
    "sub_mul": (_PROTOCOL_CU, f"{_PK}:353"),
    "from_mont_pack_words": (_PROTOCOL_CU, f"{_PK}:373"),
    "fri_fold_pre": (_FRI_CU, f"{_PK}:433"),
    "fri_fold_post": (_FRI_CU, f"{_PK}:478"),
    # the port's own kernel: the JAX package's fold on this route is XLA glue
    "fri_fold_dft": (_FRI_CU, _FOLD_JAX),
    "residues_in": (_CRT_CU, "stark_tpu/ops/pallas_crt.py:106"),
    "matmul_fold": (_CRT_CU, "stark_tpu/ops/pallas_crt.py:176"),
    "reconstruct": (_CRT_CU, "stark_tpu/ops/pallas_crt.py:254"),
}

BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12 / 4  # 64 integer lanes an SM against 128 FP32 lanes x 2 flops
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 on the tensor cores
MONT_MUL_OPS = 136  # 32x32->64 multiply-adds of one 8-word CIOS product
# a squaring: its 36 distinct limb products (a cross product once, doubled by a
# shift) and the reduction's 72
MONT_SQR_OPS = 108
# (products, squarings) of one Poseidon hash in the permutation's optimized
# form, the least work the hash needs: the partial rounds' matrices sparse
# (5 products, not 9) and their constants on state[0] alone (Grassi et al.,
# "Poseidon", USENIX Security 2021, Appendix B; neptune's default mode),
# round 0's S-box skipped on the lanes that are the same in every hash (the
# tag, a leaf's 0), the last round's matrix on the output lane alone, and the
# conversions into and out of Montgomery form folded into those two rounds'
# constants. An S-box x^5 is two squarings and a product.
# `tests/test_torch_poseidon.py` runs this form on python ints, counting.
POSEIDON_PAIR_PRODUCTS, POSEIDON_LEAF_PRODUCTS = (416, 156), (412, 154)


def poseidon_ops(products: tuple[int, int]) -> int:
    """Integer operations of one hash of (products, squarings)."""
    return products[0] * MONT_MUL_OPS + products[1] * MONT_SQR_OPS
# The lane form's latency model for a narrow level: about 4 dependent
# products a round (an S-box's three, then the round's row) over the 63
# rounds, each at the time of one dependent radix-2^29 squaring on an H100
# 80GB HBM3 at 700 W (0.444 us, scripts/mpow_kernels_cuda.py, PERF.md row 5)
POSEIDON_CHAIN = 4 * 63
DEPENDENT_PRODUCT_US = 0.444
BLAKE2S_OPS = 960  # 32-bit integer operations of one compression
SLEEP_CYCLES = 1_000_000  # about 0.5 ms of SM clock: the wait `median_ms` puts first

# ported, but not run by the prover's stages (see the module docstring)
OFF_PATH = ("linear_combination", "butterfly_stage")
# run only on FRI's Lagrange fold route: counted in the serve phase
LAGRANGE_ONLY = ("fri_fold_pre", "fri_fold_post")
# run only on FRI's default fold route, once a round of every prove on it
DFT_ONLY = ("fri_fold_dft",)
# run only on the CRT LDE engine: counted in the crt phase
CRT_ONLY = ("residues_in", "matmul_fold", "reconstruct")
# run only by a Shoup-form plan (`ntt.make_lde_plan(shoup=True)`), which no
# entry point builds: counted in the `shoup_lde` record's run
SHOUP_ONLY = ("butterfly_pass_shoup", "butterfly_fused_shoup")
# the butterfly engine's LDE kernels: a verify runs them only for its 6 columns
LDE_KERNELS = ("butterfly_pass", "butterfly_fused")
# run only under digest="poseidon": counted in the real-size Poseidon prove
POSEIDON_ONLY = ("poseidon_leaves", "poseidon_pairs")
# run only for circuits with more public wires than the real-size circuit's
# two (spans of points): counted in the `bits` golden's first prove
BITS_ONLY = ("vanishing_coeffs",)
# the fused quotient kernels: the mesh computes the quotients in the JAX
# package's mesh form (rolls, then `mmul` products), so its path skips them
MESH_OFF = ("q1_eval", "q2_eval", "q3_eval")
# the mesh phase's sizes; NCCL runs d = 2 where the host has two cards
MESH_SIZES = (2, 4)
MESH_TIMEOUT_S = 300
# `mxu_ntt.lde_mxu_sharded`'s case in the mesh phase: a column of the
# real-size prove's steps extended to its precision
MESH_LDE_STEPS, MESH_LDE_PRECISION = 1 << 17, 1 << 20
# the wrappers of `protocol/kernels.py` whose device time the goldens phase
# reads within the `bits` golden's first prove (its 1,062 public wires)
BITS_TIMED = ("horner_eval", "vanishing_eval")
LONG_D, LONG_POINTS = 1062, 1061  # the `bits` golden's public wires; one fewer
N_CHECK = 1 << 14  # where the long cases are compared with their plain versions
# the share of a synced prove's wall that may lie outside its top-level phases
TRACED_OUTSIDE = 0.10
# the engine's disk cache of host-built tables, inside the (ignored) build tree
PLAN_CACHE = os.path.join(ROOT, "stark_tpu_torch", "_build", "plans")
PROVE_MANY_X0 = (3, 5, 7, 11)  # start values of the four pipelined witnesses
# (fixture circuit, its committed golden proof, the (fri_fold, lde_engine)
# routes it is proved on): the two larger circuits skip the crt engine, for time
BUTTERFLY_ROUTES = (("dft", "butterfly"), ("lagrange", "butterfly"))
GOLDENS = (("compute", "compute_proof_golden.json", BUTTERFLY_ROUTES + (("dft", "crt"),)),
           ("poseidon3_test", "poseidon3_proof_golden.json",
            BUTTERFLY_ROUTES + (("dft", "crt"),)),
           ("bits", "bits_proof_golden.json", BUTTERFLY_ROUTES),
           ("pedersen_test", "pedersen_proof_golden.json", BUTTERFLY_ROUTES))
# the `compute` proof under digest="poseidon", proved on BUTTERFLY_ROUTES
POSEIDON_GOLDEN = "compute_proof_poseidon_golden.json"
FUSED_ONE_BLOCK = 2048  # a `butterfly_fused` case of a single block
# `butterfly_fused_shoup`'s small blocks: one CTA a block (2), the smallest
# cluster (4), and two more, on a column of FUSED_SHOUP_SMALL elements
FUSED_SHOUP_BLOCKS = (2, 4, 16, 1024)
FUSED_SHOUP_SMALL = 1 << 15
CHAIN_STEPS = 48  # dependent 64-bit multiply-adds on one CIOS product's critical path
CYCLES_PER_STEP = 8  # two dependent integer instructions of 4 cycles

RECORDS: list[dict] = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def wrappers():
    from stark_tpu_torch.ops import blake2s, crt_cuda, field_cuda, ntt, poseidon
    from stark_tpu_torch.protocol import fused_kernels as fk

    out = {
        "mmul": field_cuda.mmul,
        "butterfly_stage": ntt.butterfly_stage,
        "butterfly_pass": ntt.butterfly_pass,
        "butterfly_fused": ntt.butterfly_fused,
        "butterfly_pass_shoup": ntt.butterfly_pass_shoup,
        "butterfly_fused_shoup": ntt.butterfly_fused_shoup,
        "blake2s_words": blake2s.blake2s_words,
        "mpow_scalar": field_cuda.mpow_scalar,
        "scan_prod": field_cuda.scan_prod,
        "poseidon_leaves": poseidon.poseidon_leaves,
        "poseidon_pairs": poseidon.poseidon_pairs,
    }
    for name in list(KERNELS)[len(out):]:
        out[name] = getattr(crt_cuda if name in CRT_ONLY else fk, name)
    return out


def random_planes(rng, spec, n: int, device) -> torch.Tensor:
    """(16, n) canonical limb planes: a top limb below p's keeps every value
    below p."""
    L = spec.num_limbs
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, spec.p_limbs[L - 1], size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def random_words(rng, rows: int, n: int, device) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=(rows, n), dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, after one warm run. A
    sleep kernel holds the device before each start event, so that the
    host's work of issuing fn's launches (checks, allocation, the ctypes
    call) ends before the timed span begins; a plain version that issues
    for longer than the sleep is still timed partly on the host's clock."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the uint32 values (0 when bit-identical)."""
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max().item())


def compare(name: str, kernel_fn, plain_fn, cases: dict, reps=(10, 2),
            ops_per_s: float = INT_OPS_PER_S, library_prep=None) -> dict:
    """Run kernel and plain version on each case: exact equality required.
    A case is (args, bytes moved, operations[, dependent products]), the
    operations a count of the kind the card does `ops_per_s` of, or a list
    of (count, rate) pairs, one a kind; `add_bounds` turns these into
    `bound_ms` and `chain_ms`. The first case is the one the
    `kernels` line reports. With reps[1] == 0 the plain version's time is
    that of its one comparison call (for plain versions that take seconds).
    `library_prep(*args)`, where given, returns a function of no arguments
    that does the same work through library calls: it is timed beside the
    kernel and used nowhere else."""
    per_case, err = {}, 0
    for label, (args, nbytes, ops, *chain) in cases.items():
        got = kernel_fn(*args)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = plain_fn(*args)
        end.record()
        torch.cuda.synchronize()
        once_ms = start.elapsed_time(end)
        for g, w in zip(*[(x,) if torch.is_tensor(x) else x for x in (got, want)]):
            e = max_abs_err(g, w)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} [{label}]: kernel != plain (max abs err {e})")
            err = max(err, e)
        per_case[label] = {"ms": median_ms(lambda: kernel_fn(*args), reps[0]),
                           "plain_ms": (median_ms(lambda: plain_fn(*args), reps[1])
                                        if reps[1] else once_ms),
                           "bytes": nbytes, "ops": ops, "ops_per_s": ops_per_s,
                           "library_ms": (median_ms(library_prep(*args), reps[0])
                                          if library_prep else None),
                           "chain": chain[0] if chain else 0}
    return {"max_abs_err": err, "cases": per_case}


def add_bounds(result: dict, sm_hz: float) -> None:
    """Fill each case's `bound_ms`/`bound_by` and, for a chain of dependent
    products, `chain_ms` (see the module docstring)."""
    for c in result["cases"].values():
        by_bytes = c["bytes"] / BYTES_PER_S * 1e3
        per_s = c.pop("ops_per_s")
        kinds = c["ops"] if isinstance(c["ops"], list) else [(c["ops"], per_s)]
        by_ops = max(count / rate for count, rate in kinds) * 1e3
        c["bound_ms"] = max(by_bytes, by_ops)
        c["bound_by"] = "operations" if by_ops > by_bytes else "bytes"
        c["bound_share"] = c["bound_ms"] / c["ms"]
        if len(kinds) == 1:
            c["achieved_ops_per_s"] = kinds[0][0] / (c["ms"] * 1e-3)
        chain = c.pop("chain")
        c["chain_ms"] = (chain * CHAIN_STEPS * CYCLES_PER_STEP / sm_hz * 1e3
                         if chain else None)


def with_edges(spec, planes: torch.Tensor) -> torch.Tensor:
    """The same planes with p - 1 in the first two columns (flattened past
    the limb axis) and 0 in the last."""
    L = spec.num_limbs
    out = planes.clone()
    flat = out.reshape(L, -1)
    top = torch.tensor([(spec.p - 1 >> 16 * i) & 0xFFFF for i in range(L)],
                       dtype=torch.int32, device=planes.device)
    flat[:, :2] = top[:, None]
    flat[:, -1] = 0
    return out


def fold_inputs(spec, rng, q: int, device):
    """sx (16, 1), xs4 and ys4 (16, 4, q) of a fold round (q >= 8): random x
    and y with 0, 1 and p - 1 among them, each in a row of its own; row 3
    with two equal x (its denominators 0); sx equal to member 2 of row 5
    (that row's fold is its y_2)."""
    from stark_tpu_torch.ops import modmath as mm

    xs4, ys4 = (with_edges(spec, random_planes(rng, spec, 4 * q, device)).reshape(16, 4, q)
                for _ in range(2))
    xs4[:, 1, 2:3] = mm.mont_one(spec, device)
    ys4[:, 2, 3:4] = mm.mont_one(spec, device)
    xs4[:, 3, 3] = xs4[:, 0, 3]
    return xs4[:, 2, 5:6].clone(), xs4, ys4


def fold_dft_cases(spec, bls, device) -> dict:
    """`fri_fold_dft`'s cases: the rounds of a 2^23 prove, 0-2 (q = 2^21,
    2^19, 2^17: the whole domain's table read at strides 1, 4 and 16) and
    the last three (q = 2^9, 2^7, 2^5), with random root words, all ones
    (2^256 - 1, above p) and zero in turn, and 0 and p - 1 among the values
    and points; then BLS12-381's scalar field at q = 2^16. Bytes: 4 values
    and x^-1 in, one element out; operations: 5 products a row."""
    rng = np.random.default_rng(SEED + 24)
    roots = (torch.from_numpy(rng.integers(0, 1 << 32, 8, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(device),
             torch.full((8,), -1, dtype=torch.int32, device=device),
             torch.zeros(8, dtype=torch.int32, device=device))
    cases = {}
    for field, n_full, rounds in ((spec, BIG_PRECISION, (0, 1, 2, 6, 7, 8)), (bls, 1 << 18, (0,))):
        xs = with_edges(field, random_planes(rng, field, n_full, device))
        for k, r in enumerate(rounds):
            q = n_full >> (2 * r + 2)
            values = with_edges(field, random_planes(rng, field, 4 * q, device))
            name = "" if field is spec else f"{field.name} "
            cases[f"{name}q={q} round {r}"] = ((field, roots[k % 3], values, xs), 384 * q,
                                               5 * q * MONT_MUL_OPS)
    return cases


def phase_kernels(spec, device, steps: int, precision: int, original_steps: int,
                  sm_hz: float) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    from stark_tpu_torch.ops import blake2s as b2
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm
    from stark_tpu_torch.ops import ntt
    from stark_tpu_torch.protocol import fused_kernels as fk

    rng = np.random.default_rng(SEED)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    big = ntt.NttPlan(spec, g2, precision, "dit", device)
    small = ntt.NttPlan(spec, spec.inv(g1), steps, "dif", device)
    N, MM = precision, MONT_MUL_OPS
    plane = 64 * N  # bytes of one (16, N) int32 plane
    skips = precision // steps
    kshift = original_steps // 3 * skips
    rand = lambda n: random_planes(rng, spec, n, device)  # noqa: E731
    x_big, y_big = rand(N), rand(N)
    x_small = rand(steps)
    out = {}
    out["mmul"] = compare(
        "mmul",
        lambda a, b: fc.mmul(spec, a, b),
        lambda a, b: fc.mmul_plain(spec, a, b),
        {f"(16,{N})": ((x_big, y_big), 3 * plane, N * MM)},
        reps=(10, 3),
    )
    stage_cases = {
        f"{kind} n={n} m={m} l={l}": ((x, tw, m, l, kind),
                                      2 * 64 * n + 4 * tw.numel(), n // 2 * MM)
        for kind, n, x, plan in (("dit", N, x_big, big), ("dif", steps, x_small, small))
        for (m, l, tw) in plan.singles
    }
    out["butterfly_stage"] = compare(
        "butterfly_stage",
        lambda x, tw, m, l, kind: ntt.butterfly_stage(spec, x, tw, m, l, kind),
        lambda x, tw, m, l, kind: ntt.butterfly_stage_plain(spec, x, tw, m, l, kind),
        stage_cases,
    )
    out["butterfly_pass"] = compare_pass(spec, big, small, x_big, x_small)
    out["butterfly_fused"] = compare_fused(spec, big, small, x_big, x_small)
    out.update(compare_shoup(spec, g2, spec.inv(g1), N, steps, device))
    out["blake2s_words"] = compare(
        "blake2s_words",
        b2.blake2s_words,
        b2.blake2s_words_plain,
        {f"(64,{N}) 256-byte leaves": ((random_words(rng, 64, N, device), 256),
                                       4 * (64 + 8) * N, 4 * N * BLAKE2S_OPS),
         f"(16,{N // 2}) 64-byte nodes": ((random_words(rng, 16, N // 2, device), 64),
                                          4 * (16 + 8) * (N // 2), N // 2 * BLAKE2S_OPS)},
    )

    out["mpow_scalar"] = compare_mpow(spec, rand)
    # the Lagrange fold inverts all N denominators of round 0, the accumulator
    # scans `steps`: the plan's levels of both, then two fixed shapes (the
    # first plan's levels at these sizes) that stay comparable across plans
    scan_shapes = {f"n={n} level (16,{B},{C})": (B, C)
                   for n in (N, steps) for (B, C) in mm.scan_levels(n)}
    scan_shapes.update({f"fixed (16,64,{C})": (64, C) for C in (N // 64, steps // 64)})
    out["scan_prod"] = compare(
        "scan_prod",
        lambda x: fc.scan_prod(spec, x),
        lambda x: fc.scan_prod_plain(spec, x),
        {label: ((with_edges(spec, rand(B * C).reshape(16, B, C)),),
                 2 * 64 * B * C, B * C * MM, mm.scan_chain(B, C))
         for label, (B, C) in scan_shapes.items()},
        reps=(10, 0),
    )
    for label, (B, C) in scan_shapes.items():
        out["scan_prod"]["cases"][label]["team"] = fc.scan_team(B, C)

    r3, k11 = rand(3), rand(11)
    cols = [rand(N) for _ in range(7)] + [x_big, y_big]
    a_edge, c_edge = with_edges(spec, x_big), with_edges(spec, y_big).flip(1).contiguous()
    out["rand_combination"] = compare(
        "rand_combination",
        lambda *a: fk.rand_combination(spec, *a),
        lambda *a: fk.rand_combination_plain(spec, *a),
        {f"n={N}": ((r3, *cols[:3]), 5 * plane, 3 * N * MM),
         f"n={steps}": ((r3, x_small, rand(steps), rand(steps)), 5 * 64 * steps, 3 * steps * MM)},
    )
    out["q1_eval"] = compare(
        "q1_eval",
        lambda *a: fk.q1_eval(spec, *a),
        lambda *a: fk.q1_eval_plain(spec, *a),
        {f"n={N} skips={skips}": ((*cols[:5], skips), 6 * plane, 3 * N * MM)},
    )
    # the prover's shift first (grouped by `fused_kernels.q2_plan`), then the
    # straight order's shifts and the 2^17 domain's prover shape; the q2 and
    # linear combination cases past their first draw from a generator of
    # their own, so that the other kernels' inputs do not depend on them
    extra = np.random.default_rng(SEED + 8)
    small_n, small_kshift = N // 8, N // 64 // 3 * skips
    q2_cases = {f"n={N} kshift={k}": ((*cols[:2], k), 3 * plane, 2 * N * MM)
                for k in (kshift, 0, 1, N - 1)}
    q2_cases[f"n={small_n} kshift={small_kshift}"] = (
        (with_edges(spec, random_planes(extra, spec, small_n, device)),
         random_planes(extra, spec, small_n, device), small_kshift),
        3 * 64 * small_n, 2 * small_n * MM)
    out["q2_eval"] = compare(
        "q2_eval",
        lambda *a: fk.q2_eval(spec, *a),
        lambda *a: fk.q2_eval_plain(spec, *a),
        q2_cases,
    )
    out["q3_eval"] = compare(
        "q3_eval",
        lambda *a: fk.q3_eval(spec, *a),
        lambda *a: fk.q3_eval_plain(spec, *a),
        {f"n={N} skips={skips}": ((*cols[:3], skips), 4 * plane, 2 * N * MM)},
    )
    out["linear_combination"] = compare(
        "linear_combination",
        lambda *a: fk.linear_combination(spec, *a),
        lambda *a: fk.linear_combination_plain(spec, *a),
        {f"n={N}": ((k11, *cols), 10 * plane, 11 * N * MM)},
    )
    # a pattern of `skips` plain constants, as the stages build it: 0 (the
    # first of Z^-1), 1 and p - 1 among them
    consts = [0, 1, spec.p - 1] + [
        int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(skips - 3)
    ]
    pats = mm.shoup_consts(spec, consts, device)
    pat_bytes = 2 * 64 * skips
    # the same constants tiled wider than a thread block: the kernels' other
    # way to stage a pattern, which the prover's stages do not use
    wide = tuple(p.repeat(1, 1024 // skips) for p in pats)
    out["shoup_mul_periodic"] = compare(
        "shoup_mul_periodic",
        lambda *a: fk.shoup_mul_periodic(spec, *a),
        lambda *a: fk.shoup_mul_periodic_plain(spec, *a),
        {f"n={N} t={skips}": ((*pats, a_edge), 2 * plane + pat_bytes, N * MM),
         f"n={N} t=1024": ((*wide, a_edge), 2 * plane + 2 * 64 * 1024, N * MM)},
    )
    # 8 products an element (the x^steps terms folded into 3 coefficients a
    # pattern column, 3 products each); the edge case: every k_j p - 1, every
    # plane through `with_edges`; then BLS12-381's scalar field
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls

    k_top = with_edges(spec, k11)
    k_top[:] = k_top[:, :1]
    lc_cases = {
        f"n={N} t={skips}": ((spec, k11, *pats, *cols[1:]), 9 * plane + pat_bytes,
                             (8 * N + 3 * skips) * MM),
        f"n={N} t=1024": ((spec, k11, *wide, *cols[1:]), 9 * plane + 2 * 64 * 1024,
                          (8 * N + 3 * 1024) * MM),
        f"n={N} t={skips} edges": ((spec, k_top, *pats, *[with_edges(spec, c) for c in cols[1:]]),
                                   9 * plane + pat_bytes, (8 * N + 3 * skips) * MM)}
    bls_n = N // 16
    bls_pats = mm.shoup_consts(bls, [0, 1, bls.p - 1] + [
        int.from_bytes(extra.bytes(32), "little") % bls.p for _ in range(skips - 3)], device)
    lc_cases[f"{bls.name} n={bls_n} t={skips}"] = (
        (bls, with_edges(bls, random_planes(extra, bls, 11, device)), *bls_pats,
         *[with_edges(bls, random_planes(extra, bls, bls_n, device)) for _ in range(8)]),
        9 * 64 * bls_n + pat_bytes, (8 * bls_n + 3 * skips) * MM)
    out["linear_combination_shoup"] = compare(
        "linear_combination_shoup",
        fk.linear_combination_shoup,
        fk.linear_combination_shoup_plain,
        lc_cases,
    )
    out.update(compare_groups(spec, rand, x_big, a_edge, sm_hz))
    out["sub_mul"] = compare(
        "sub_mul",
        lambda *a: fk.sub_mul(spec, *a),
        lambda *a: fk.sub_mul_plain(spec, *a),
        {f"n={N} plane b": ((a_edge, cols[0], c_edge), 4 * plane, N * MM),
         f"n={N} column b": ((a_edge, mm.mont_one(spec, device), c_edge), 3 * plane, N * MM)},
    )
    out["from_mont_pack_words"] = compare(
        "from_mont_pack_words",
        lambda c: fk.from_mont_pack_words(spec, c),
        lambda c: fk.from_mont_pack_words_plain(spec, c),
        {f"n={N}": ((a_edge,), plane + plane // 2, N * MM)},
    )

    # every round's quarter of a 2^20 domain, 2^18 down to 2^6, and one that
    # is no multiple of a block (nor of 128); then BLS12-381's scalar field
    folds = {f"q={q}": (spec, *fold_inputs(spec, rng, q, device))
             for q in [N >> 2 * k for k in range(1, 8)] + [192]}
    folds[f"{bls.name} q={N // 16}"] = (bls, *fold_inputs(bls, rng, N // 16, device))
    pre_cases, post_cases = {}, {}
    for label, (field, sx, xs4, ys4) in folds.items():
        q = xs4.shape[2]
        dens = fk.fri_fold_pre_plain(field, xs4)
        invs = mm.multi_inv(field, dens.reshape(16, 4 * q)).reshape(16, 4, q)
        pre_cases[label] = ((field, xs4), 512 * q, 8 * q * MM)
        post_cases[label] = ((field, sx, xs4, ys4, invs), 832 * q + 64, 14 * q * MM)
    out["fri_fold_pre"] = compare("fri_fold_pre", fk.fri_fold_pre, fk.fri_fold_pre_plain,
                                  pre_cases)
    out["fri_fold_post"] = compare("fri_fold_post", fk.fri_fold_post, fk.fri_fold_post_plain,
                                   post_cases)
    out["fri_fold_dft"] = compare("fri_fold_dft", fk.fri_fold_dft, fk.fri_fold_dft_plain,
                                  fold_dft_cases(spec, bls, device))
    out.update(compare_poseidon(device, sm_hz))
    for result in out.values():
        add_bounds(result, sm_hz)
    return out


def time_alone(result: dict, label: str, fn, args, nbytes: int, ops: int,
               reps: int = 5) -> None:
    """Add to a `compare` result a case timed without its plain version (held
    to it at a smaller n by another case)."""
    result["cases"][label] = {"ms": median_ms(lambda: fn(*args), reps), "plain_ms": None,
                              "bytes": nbytes, "ops": ops, "ops_per_s": INT_OPS_PER_S,
                              "library_ms": None, "chain": 0}


def compare_groups(spec, rand, x_big, a_edge, sm_hz: float) -> dict:
    """`horner_eval`, `vanishing_eval` and the pre-pass of the latter,
    `vanishing_coeffs`. Horner: the prover's d = 2 first, then 1, 3, 4, 5,
    8, 9 and 17 (each side of the groups of `fused_kernels.GROUPS`) at 2^20;
    d = 1,062 (the `bits` golden's public wires) compared at 2^14 on the
    first columns of the 2^20 case, which is timed alone and must equal it
    there; d = 17 on BLS12-381's field at 2^16. The vanishing product
    likewise at 2, 0, 1, 3, 5, 8, 9, 17 and 1,061 points, and on BLS12-381
    at 17 and 100 (where 2^16 elements pay for the pre-pass). The pre-pass at
    1,062 points (33 spans of 32 and one of 6) and 17, on both fields (its
    plain version takes seconds). Bounds: Horner's d - 1 products an
    element, the product's npts - 1, the pre-pass's s(s - 1)/2 a span of s;
    `floor_ms`, each case's operations a thread in the kernel's design
    (`fused_kernels.horner_ops`, `vanishing_ops`) at the clocks of
    `fused_kernels._COST`. The plain versions' times are of their one
    comparison call."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.protocol import fused_kernels as fk

    device, N, MM = x_big.device, x_big.shape[1], MONT_MUL_OPS
    plane = 64 * N
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    hv = np.random.default_rng(SEED + 12)

    def hv_planes(field, n):
        planes = random_planes(hv, field, n, device)
        return with_edges(field, planes) if n else planes

    bls_n = N // 16
    x_check, x_bls = a_edge[:, :N_CHECK].contiguous(), hv_planes(bls, bls_n)
    # the parent's draws for d = 2, 17 and 2, 17 points, then this function's own
    horner_in = {(spec, d, N): (rand(d), x_big) for d in (2, 17)}
    vanish_in = {(spec, k, N): (x_big, rand(k)) for k in (2, 17)}
    horner_in.update({(spec, d, N): (hv_planes(spec, d), x_big) for d in (1, 3, 4, 5, 8, 9)})
    vanish_in.update({(spec, k, N): (x_big, hv_planes(spec, k)) for k in (0, 1, 3, 5, 8, 9)})
    long_c, long_pts = hv_planes(spec, LONG_D), hv_planes(spec, LONG_POINTS)
    horner_in[(spec, LONG_D, N_CHECK)] = (long_c, x_check)
    vanish_in[(spec, LONG_POINTS, N_CHECK)] = (x_check, long_pts)
    horner_in[(bls, 17, bls_n)] = (hv_planes(bls, 17), x_bls)
    vanish_in[(bls, 17, bls_n)] = (x_bls, hv_planes(bls, 17))
    vanish_in[(bls, 100, bls_n)] = (x_bls, hv_planes(bls, 100))  # spans at 2^16

    def label(field, count, n, what):
        return f"{'' if field is spec else field.name + ' '}n={n} {what}={count}"

    def floor_ms(ops: dict, n: int) -> float:
        return fk.ops_cost(ops) * n / (sms * sm_hz) * 1e3

    out = {}
    for name, inputs, what, choose, ops_of in (
            ("horner_eval", horner_in, "d", fk.horner_group, fk.horner_ops),
            ("vanishing_eval", vanish_in, "points", fk.vanishing_group, fk.vanishing_ops)):
        wrapper, plain = getattr(fk, name), getattr(fk, name + "_plain")
        cases = {label(field, count, n, what): ((field, *args), 2 * 64 * n,
                                                 max(count - 1, 0) * n * MM)
                 for (field, count, n), args in inputs.items()}
        result = compare(name, wrapper, plain, cases, reps=(10, 0))
        long = LONG_D if name == "horner_eval" else LONG_POINTS
        args = (spec, long_c, a_edge) if name == "horner_eval" else (spec, a_edge, long_pts)
        got = wrapper(*args)
        if not torch.equal(got[:, :N_CHECK], wrapper(*cases[label(spec, long, N_CHECK, what)][0])):
            raise AssertionError(f"{name}: the 2^20 case differs from the 2^14 one on its columns")
        time_alone(result, label(spec, long, N, what), wrapper, args, 2 * plane,
                   (long - 1) * N * MM)
        for (field, count, n) in list(inputs) + [(spec, long, N)]:
            case = result["cases"][label(field, count, n, what)]
            case["group"] = (choose(field, count) if name == "horner_eval"
                             else choose(field, count, n))
            case["design_ops"] = ops_of(count, case["group"])
            case["floor_ms"] = floor_ms(case["design_ops"], n)
        out[name] = result

    coeff_cases = {}
    for field, count in ((spec, LONG_D), (spec, 17), (bls, 17)):
        pts = hv_planes(field, count)
        spans = [fk.SPAN] * (count // fk.SPAN) + [count % fk.SPAN] * (count % fk.SPAN > 0)
        prefix = "" if field is spec else field.name + " "
        coeff_cases[f"{prefix}points={count}"] = (
            (field, pts), 2 * 64 * count, sum(s * (s - 1) // 2 for s in spans) * MM)
    out["vanishing_coeffs"] = compare("vanishing_coeffs", fk.vanishing_coeffs,
                                      fk.vanishing_coeffs_plain, coeff_cases, reps=(10, 0))
    return out


def compare_mpow(spec, rand) -> dict:
    """`mpow_scalar` against its plain version: e = p - 2 at (16, 1) (the
    prover's Fermat inversion) and (16, 8) on BN254's scalar field and at
    (16, 1) on BLS12-381's; e = 0, 1 and 2^256 - 1 at (16, 4) on 0,
    Montgomery one, p - 1 and a random value; e =
    2^255 and 2^127 at (16, 1), whose difference over 128 is the time of
    one dependent squaring (`squaring_step_ms`), beside the time of the
    whole chain over its length (`dependent_product_ms`)."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import field_cuda as fc

    def products(e):
        """The products a^e needs: bit_length - 1 squarings, popcount - 1 multiplies."""
        return max(e.bit_length() - 1, 0) + max(bin(e).count("1") - 1, 0)

    def case(field, a, e):
        k = a.shape[1]
        return ((field, a, e), 2 * 64 * k, k * products(e) * MONT_MUL_OPS, e.bit_length())

    rng = np.random.default_rng(SEED + 7)
    one_lane = "(16,1) e=p-2"
    edges = rand(4)
    edges[:, :3] = torch.tensor([[(v >> 16 * i) & 0xFFFF for v in (0, spec.r_mod_p, spec.p - 1)]
                                 for i in range(16)], dtype=torch.int32, device=edges.device)
    cases = {one_lane: case(spec, rand(1), spec.p - 2),
             "(16,8) e=p-2": case(spec, with_edges(spec, rand(8)), spec.p - 2),
             f"{bls.name} (16,1) e=p-2": case(
                 bls, random_planes(rng, bls, 1, edges.device), bls.p - 2)}
    cases.update({f"(16,4) edges e={label}": case(spec, edges, e)
                  for label, e in (("0", 0), ("1", 1), ("2^256-1", (1 << 256) - 1))})
    steps = {label: case(spec, rand(1), e) for label, e in
             (("(16,1) e=2^255", 1 << 255), ("(16,1) e=2^127", 1 << 127))}
    cases.update(steps)
    result = compare("mpow_scalar",
                     lambda field, a, e: fc.mpow_scalar(field, a, e),
                     lambda field, a, e: fc.mpow_scalar_plain(field, a, e),
                     cases, reps=(10, 0))
    ms = {label: result["cases"][label]["ms"] for label in [one_lane, *steps]}
    result["dependent_product_ms"] = ms[one_lane] / (spec.p - 2).bit_length()
    result["squaring_step_ms"] = (ms["(16,1) e=2^255"] - ms["(16,1) e=2^127"]) / 128
    return result


def ptxas_of(fragment: str) -> dict:
    """{kernel: {"registers", "spill_stores", "stack_bytes"}} of the
    library's kernels whose mangled name holds `fragment`, from the build's
    `ptxas -v` log."""
    from stark_tpu_torch.ops import build

    with open(os.path.join(os.path.dirname(build.library_path()), "build.log")) as f:
        log = f.read()
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if fragment in m.group(1) else None
            if name:
                usage[name] = {"registers": None, "spill_stores": None, "stack_bytes": None}
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and usage[name]["stack_bytes"] is None:
            usage[name]["stack_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and usage[name]["spill_stores"] is None:
            usage[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and usage[name]["registers"] is None:
            usage[name]["registers"] = int(m.group(1))
    return usage


def poseidon_words(rng, rows: int, n: int, bound: int, device) -> torch.Tensor:
    """(rows, n) int32 words: in rows 0-7 the little-endian words of random
    values below `bound` (the top word below the bound's), with 0, 1, BN254's
    r - 1 and BLS12-381's p - 1 in the first columns where they are below
    `bound`; the rows past 7 random (a leaf buffer's padding, which the
    hash must not read)."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls, BN254_FR as bn

    w = rng.integers(0, 1 << 32, size=(rows, n), dtype=np.int64)
    w[7] = rng.integers(0, bound >> 224, size=n)
    edges = [v for v in (0, 1, bn.p - 1, bls.p - 1) if v < bound][:n]
    for j, v in enumerate(edges):
        w[:8, j] = [(v >> 32 * k) & 0xFFFFFFFF for k in range(8)]
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def compare_poseidon(device, sm_hz: float) -> dict:
    """`poseidon_leaves` and `poseidon_pairs` against their plain versions
    (`torch.equal`): the l-tree's leaf layer, 2^20 leaves of BN254 values in a
    (16, 2^20) buffer, and a fold level of 2^19 pairs of BLS12-381 values,
    then each at 2^17, 1 and 3 hashes, on both sides of the wrapper's width
    constant (`poseidon.LANE_FORM_BELOW`: the lane form below it, a thread
    a hash at it), at 2^13, 2^10 and 33 (a ragged warp of the lane form);
    0, 1, r - 1 and p - 1 among the inputs (`poseidon_words`). Each case
    names its form. The plain versions' times are of their one comparison
    call (about 10 s at 2^20). Bounds: the products and squarings of a hash
    in its optimized form (`POSEIDON_*_PRODUCTS`, `poseidon_ops`) over the
    integer rate; bytes: 32 read for a leaf (its value's rows), 64 for a
    pair, 32 written. Then, timed alone, the levels of a 2^20 tree as the
    prover runs them (`levels`: the leaf layer, then one fold a level down
    to one hash), each with its form and bound, the narrow ones (the lane
    form) also with the latency model's `model_ms` (`POSEIDON_CHAIN`
    dependent products at `DEPENDENT_PRODUCT_US`); and `ptxas -v`'s
    registers, stack and spills of the kernel's four builds."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls, BN254_FR as bn
    from stark_tpu_torch.ops import poseidon as pos

    rng = np.random.default_rng(SEED + 14)
    big, w = 1 << 20, pos.LANE_FORM_BELOW
    sizes = (big, big >> 3, 1, 3, w - 1, w, 1 << 13, 1 << 10, 33)
    leaf_ops, pair_ops = (poseidon_ops(POSEIDON_LEAF_PRODUCTS),
                          poseidon_ops(POSEIDON_PAIR_PRODUCTS))
    leaf_in = {n: poseidon_words(rng, 16, n, bn.p, device) for n in sizes}
    pair_in = {n: poseidon_words(rng, 8, 2 * n, bls.p, device) for n in (big >> 1,) + sizes[1:]}

    def form(n: int) -> str:
        return "lanes" if pos.lane_form(n) else "thread"

    out = {
        "poseidon_leaves": compare(
            "poseidon_leaves", pos.poseidon_leaves, pos.poseidon_leaves_plain,
            {f"(16,{n}) leaves, {form(n)}": ((x,), 64 * n, n * leaf_ops)
             for n, x in leaf_in.items()},
            reps=(10, 0)),
        "poseidon_pairs": compare(
            "poseidon_pairs", pos.poseidon_pairs, pos.poseidon_pairs_plain,
            {f"(8,{2 * n}) {n} pairs, {form(n)}": ((x,), 96 * n, n * pair_ops)
             for n, x in pair_in.items()},
            reps=(10, 0)),
    }
    levels = []
    h = pos.poseidon_leaves(leaf_in[big])
    ms = median_ms(lambda: pos.poseidon_leaves(leaf_in[big]), 5)
    levels.append({"kernel": "poseidon_leaves", "hashes": big, "ms": ms})
    while h.shape[1] > 1:
        layer = h
        levels.append({"kernel": "poseidon_pairs", "hashes": layer.shape[1] // 2,
                       "ms": median_ms(lambda: pos.poseidon_pairs(layer), 5)})
        h = pos.poseidon_pairs(layer)
    for lv in levels:
        ops = lv["hashes"] * (leaf_ops if lv["kernel"] == "poseidon_leaves" else pair_ops)
        lv["form"] = form(lv["hashes"])
        lv["bound_ms"] = ops / INT_OPS_PER_S * 1e3
        lv["us_per_hash"] = lv["ms"] * 1e3 / lv["hashes"]
        if pos.lane_form(lv["hashes"]):
            lv["model_ms"] = POSEIDON_CHAIN * DEPENDENT_PRODUCT_US * 1e-3
    out["poseidon_pairs"]["levels"] = levels
    out["poseidon_pairs"]["tree_ms"] = sum(lv["ms"] for lv in levels)
    out["poseidon_pairs"]["ptxas"] = ptxas_of("poseidon")
    return out


def phase_prefix(spec, device, steps: int, precision: int) -> dict:
    """`prefix_prod` forward and reversed and `multi_inv` (with zeros) at the
    sizes the prover gives them (the accumulator's `steps`, the Lagrange
    fold's first `precision`) and at lengths that are no power of two: each
    call's device time (`device_ms`, `device_busy_ms`) and its `median_ms`
    span (`ms`, which also holds the host's work after the call's first
    upload, a `mont_one`, waits for the card), its `scan_prod` launches,
    and equality (`torch.equal`) with the same function on CPU tensors (the
    plain versions). Tolerance: exact."""
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm

    rng = np.random.default_rng(SEED + 3)
    out = {}
    for n in (steps, precision, 80, 96, 160):
        v = with_edges(spec, random_planes(rng, spec, n, device))
        v[:, n // 2] = 0
        v_cpu = v.cpu()
        for name, fn in (("prefix_prod", lambda a: mm.prefix_prod(spec, a)),
                         ("prefix_prod reversed",
                          lambda a: mm.prefix_prod(spec, a, reverse=True)),
                         ("multi_inv", lambda a: mm.multi_inv(spec, a))):
            fc.scan_prod.launches = 0
            got = fn(v)
            launches = fc.scan_prod.launches
            want = fn(v_cpu)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{name} at n={n}: the card's values differ "
                                     f"from the CPU's (max abs err "
                                     f"{max_abs_err(got.cpu(), want)})")
            out[f"{name} n={n}"] = {"device_ms": device_busy_ms(lambda: fn(v)),
                                    "ms": median_ms(lambda: fn(v), 10),
                                    "scan_launches": launches,
                                    "levels": mm.scan_levels(n)}
    return out


def compare_pass(spec, big, small, x_big, x_small) -> dict:
    """`butterfly_pass` against its plain version at every pass of the
    prover's two plans (the big transform's last pass, the widest table,
    first), on columns with 0, 1 (raw and Montgomery) and p - 1, at short
    passes (2 stages, 1 stage) and on BLS12-381's scalar field, which runs
    the kernel's canonical build, at every pass of both directions at the
    small size. Bytes: the column in and out and the table the pass reads
    (32 bytes an entry, packed words); operations: a product a butterfly."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import modmath as mm, ntt

    def edges(field, x):
        x = with_edges(field, x)
        x[:, 2:3] = mm.mont_one(field, x.device)
        x[:, 3] = 0
        x[0, 3] = 1
        return x

    N, steps = x_big.shape[1], x_small.shape[1]
    device = x_big.device
    shapes = {}
    for kind, n, x, plan in (("dit", N, x_big, big), ("dif", steps, x_small, small)):
        for l0, r, tw in plan.passes[::-1] if kind == "dit" else plan.passes:
            shapes[f"{kind} n={n} l0={l0} r={r}"] = (spec, x, tw, l0, r, kind)
    (l0, r, tw), (l0s, rs, tws) = big.passes[-1], small.passes[0]
    shapes[f"edges dit n={N} l0={l0} r={r}"] = (spec, edges(spec, x_big), tw, l0, r, "dit")
    shapes[f"edges dif n={steps} l0={l0s} r={rs}"] = (spec, edges(spec, x_small), tws, l0s,
                                                       rs, "dif")
    # short passes: the big transform's last two stages, its second last
    # alone, and the small transform's last
    (_, _, tw_top), (_, prev, tw_prev) = big.singles[-1], big.singles[-2]
    _, last, tw_last = small.singles[-1]
    shapes[f"short dit n={N} l0={prev} r=2"] = (spec, x_big, ntt.pack_words(tw_top), prev, 2,
                                                "dit")
    shapes[f"short dit n={N} l0={prev} r=1"] = (spec, x_big, ntt.pack_words(tw_prev), prev, 1,
                                                "dit")
    shapes[f"short dif n={steps} l0={last} r=1"] = (spec, x_small, ntt.pack_words(tw_last),
                                                    last, 1, "dif")
    rng = np.random.default_rng(SEED + 11)
    x = edges(bls, random_planes(rng, bls, steps, device))
    for kind in ("dit", "dif"):
        plan = ntt.NttPlan(bls, bls.root_of_unity(steps), steps, kind, device)
        for l0, r, tw in plan.passes:
            shapes[f"{bls.name} {kind} n={steps} l0={l0} r={r}"] = (bls, x, tw, l0, r, kind)
    return compare(
        "butterfly_pass",
        lambda field, x, tw, l0, r, kind: ntt.butterfly_pass(field, x, tw, l0, r, kind),
        lambda field, x, tw, l0, r, kind: ntt.butterfly_pass_plain(field, x, tw, l0, r, kind),
        {label: (args, 2 * 64 * args[1].shape[1] + 4 * args[2].numel(),
                 args[4] * args[1].shape[1] // 2 * MONT_MUL_OPS)
         for label, args in shapes.items()},
    )


def compare_fused(spec, big, small, x_big, x_small) -> dict:
    """`butterfly_fused` against its plain version at the prover's three
    shapes: dit and dif at the big transform's size on its tables, and dif
    at the small transform's (the inverse LDE's) on its own; then on
    BLS12-381's scalar field, which runs the kernel's canonical build
    (`ntt.fused_lazy`), dit and dif at the small size and at one block."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import modmath as mm, ntt

    def work(plan, n):
        return (2 * 64 * n + 4 * plan.fused_tw.numel(),
                (plan.block.bit_length() - 1) * n // 2 * MONT_MUL_OPS)

    def needed_ms(field, plan, n, nbytes):
        """The bound without the products by a twiddle equal to Montgomery
        one (the product by R mod p is its operand): those of k = 0."""
        one = (plan.fused_tw == mm.mont_one(field, plan.fused_tw.device)).all(dim=0)
        products = sum((l - int(one[l - 1 : 2 * l - 1].sum())) * n // (2 * l)
                       for l in ntt.fused_ls(plan.block, "dit"))
        return max(nbytes / BYTES_PER_S, products * MONT_MUL_OPS / INT_OPS_PER_S) * 1e3

    N, steps = x_big.shape[1], x_small.shape[1]
    device = x_big.device
    rng = np.random.default_rng(SEED + 6)
    shapes = {f"dit n={N} block={big.block}": (spec, x_big, big, "dit"),
              f"dif n={N} block={big.block}": (spec, x_big, big, "dif"),
              f"dif n={steps} block={small.block}": (spec, x_small, small, "dif")}
    for n in (steps, FUSED_ONE_BLOCK):
        x = with_edges(bls, random_planes(rng, bls, n, device))
        for kind in ("dit", "dif"):
            plan = ntt.NttPlan(bls, bls.root_of_unity(n), n, kind, device)
            shapes[f"{bls.name} {kind} n={n} block={plan.block}"] = (bls, x, plan, kind)
    result = compare(
        "butterfly_fused",
        lambda field, x, tw, block, kind: ntt.butterfly_fused(field, x, tw, block, kind),
        lambda field, x, tw, block, kind: ntt.butterfly_fused_plain(field, x, tw, block, kind),
        {label: ((field, x, plan.fused_tw, plan.block, kind), *work(plan, x.shape[1]))
         for label, (field, x, plan, kind) in shapes.items()},
    )
    for label, (field, x, plan, _) in shapes.items():
        case = result["cases"][label]
        case["bound_needed_ms"] = needed_ms(field, plan, x.shape[1], case["bytes"])
    return result


def lazy_planes(rng, spec, n: int, device) -> torch.Tensor:
    """(16, n) limb planes of values in [0, 2p) (a top limb below 2p's), the
    first six 0, 1, Montgomery one, p - 1, p and 2p - 1: the Shoup form's
    inputs."""
    L = spec.num_limbs
    top = (2 * spec.p) >> (16 * (L - 1))
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, top, size=n)
    for j, v in enumerate((0, 1, spec.r_mod_p, spec.p - 1, spec.p, 2 * spec.p - 1)):
        limbs[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(L)]
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def compare_shoup(spec, g2: int, inv_g1: int, N: int, steps: int, device) -> dict:
    """The Shoup forms against their plain versions (`torch.equal`, lazy
    values in [0, 2p) included): `butterfly_pass_shoup` at every pass of the
    2^20 DIT plan (the last, which reads the widest table and reduces below
    p, first) and of the 2^17 DIF plan, as a Shoup plan runs them, then
    their last and first on `lazy_planes`' edge values, and on BLS12-381's
    scalar field every pass of both directions at 2^17;
    `butterfly_fused_shoup` dit and dif at 2^20 (block 2048), dif and dit at
    2^17, the 2^20 cases on the edge values and reducing below p,
    BLS12-381's dit and dif at 2^17 and at one block, and on both fields
    dit (reducing below p) and dif at `FUSED_SHOUP_SMALL` in the blocks of
    `FUSED_SHOUP_BLOCKS`, each on its plan's table. Bytes: the column in
    and out and the table read (64 bytes an entry); operations: a Shoup
    product a butterfly (`MONT_MUL_OPS`)."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 12)
    big = ntt.NttPlan(spec, g2, N, "dit", device, shoup=True)
    small = ntt.NttPlan(spec, inv_g1, steps, "dif", device, shoup=True)
    x_big, x_small = (random_planes(rng, spec, n, device) for n in (N, steps))
    e_big, e_small = (lazy_planes(rng, spec, n, device) for n in (N, steps))
    passes, fused = {}, {}
    for kind, n, x, e, plan in (("dit", N, x_big, e_big, big),
                                ("dif", steps, x_small, e_small, small)):
        last = len(plan.passes) - 1
        order = range(last, -1, -1) if kind == "dit" else range(last + 1)
        for i in order:
            l0, r, tw = plan.passes[i]
            canon = kind == "dit" and i == last
            passes[f"{kind} n={n} l0={l0} r={r}{' canon' if canon else ''}"] = (
                spec, x, tw, l0, r, kind, canon)
        if plan.passes:
            l0, r, tw = plan.passes[order[0]]
            passes[f"edges {kind} n={n} l0={l0} r={r}"] = (spec, e, tw, l0, r, kind,
                                                           kind == "dit")
    for kind, x in (("dit", x_big), ("dif", x_big), ("dif", x_small)):
        n = x.shape[1]
        tw = (big if n == N else small).fused_tw  # a fused table serves both directions
        fused[f"{kind} n={n} block={FUSED_ONE_BLOCK}"] = (spec, x, tw, FUSED_ONE_BLOCK, kind,
                                                          False)
        if n == N:
            fused[f"edges {kind} n={n} block={FUSED_ONE_BLOCK} canon"] = (
                spec, e_big, tw, FUSED_ONE_BLOCK, kind, True)
    fused[f"dit n={steps} block={FUSED_ONE_BLOCK}"] = (spec, x_small, small.fused_tw,
                                                      FUSED_ONE_BLOCK, "dit", False)
    n = FUSED_SHOUP_SMALL
    for field in (spec, bls):
        x = lazy_planes(rng, field, n, device)
        for block in FUSED_SHOUP_BLOCKS:
            tw = ntt.NttPlan(field, field.root_of_unity(n), n, "dit", device, block,
                             shoup=True).fused_tw
            for kind in ("dit", "dif"):
                fused[f"{field.name} {kind} n={n} block={block}"] = (field, x, tw, block, kind,
                                                                     kind == "dit")
    for n in (steps, FUSED_ONE_BLOCK):
        x = lazy_planes(rng, bls, n, device)
        for kind in ("dit", "dif"):
            plan = ntt.NttPlan(bls, bls.root_of_unity(n), n, kind, device, shoup=True)
            canon = kind == "dit" and not plan.passes
            fused[f"{bls.name} {kind} n={n} block={plan.block}"] = (
                bls, x, plan.fused_tw, plan.block, kind, canon)
            if n == steps:
                for i, (l0, r, tw) in enumerate(plan.passes):
                    canon = kind == "dit" and i == len(plan.passes) - 1
                    passes[f"{bls.name} {kind} n={n} l0={l0} r={r}"] = (bls, x, tw, l0, r,
                                                                       kind, canon)
    out = {}
    out["butterfly_pass_shoup"] = compare(
        "butterfly_pass_shoup", ntt.butterfly_pass_shoup, ntt.butterfly_pass_shoup_plain,
        {label: (args, 2 * 64 * args[1].shape[1] + 4 * args[2].numel(),
                 args[4] * args[1].shape[1] // 2 * MONT_MUL_OPS)
         for label, args in passes.items()},
    )
    out["butterfly_fused_shoup"] = compare(
        "butterfly_fused_shoup", ntt.butterfly_fused_shoup, ntt.butterfly_fused_shoup_plain,
        {label: (args, 2 * 64 * args[1].shape[1] + 4 * args[2].numel(),
                 (args[3].bit_length() - 1) * args[1].shape[1] // 2 * MONT_MUL_OPS)
         for label, args in fused.items()},
    )
    return out


def phase_shoup_lde(spec, device, params) -> dict:
    """The 9-column LDE of the real-size prove's shape on the default plan
    and on the Shoup plan (`ntt.make_lde_plan(shoup=True)`), on the same
    random traces, in turns (default, Shoup, Shoup, default): equal outputs
    (`torch.equal`), the device time of each run, and the Shoup kernels'
    launches in the first Shoup run, every counter set to 0 just before."""
    from stark_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 13)
    traces = [random_planes(rng, spec, params.steps, device) for _ in range(9)]
    g2 = spec.root_of_unity(params.precision)
    g1 = pow(g2, params.precision // params.steps, spec.p)
    t0 = time.time()
    plans = {shoup: ntt.make_lde_plan(spec, g1, g2, params.steps, params.precision, device,
                                      shoup=shoup) for shoup in (False, True)}
    out = {"columns": len(traces), "plans_s": time.time() - t0, "runs": []}
    want = None
    wrap = wrappers()
    for shoup in (False, True, True, False):
        if shoup and "launches" not in out:
            for fn in wrap.values():
                fn.launches = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        outs = [ntt.lde(spec, t, plans[shoup]) for t in traces]
        end.record()
        torch.cuda.synchronize()
        if shoup and "launches" not in out:
            out["launches"] = {name: fn.launches for name, fn in wrap.items()}
        want = want or outs
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError(f"the {'Shoup' if shoup else 'default'} LDE differs")
        out["runs"].append({"shoup": shoup, "device_ms": start.elapsed_time(end)})
        del outs
    missing = [name for name in SHOUP_ONLY if out["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"the Shoup LDE did not launch {missing}")
    return out


def big_domain_cases(spec, device, sm_hz: float) -> dict:
    """Cases at the big-domain phase's shapes (precision 2^23, steps 2^20),
    which no earlier phase gives the kernels: every `butterfly_pass` of the
    LDE's two transforms (the 2^23 transform's 4 passes of 3 stages, the
    inverse's 3 at 2^20), `butterfly_fused` on both, `scan_prod` at each
    level of `multi_inv`'s 2^23 scans, and the m-tree's:
    `from_mont_pack_words` from a column into 8 rows of the (64, 2^23) leaf
    words, `blake2s_words` over those words, and over the first layer of
    nodes above them. Each equal to its plain version (`torch.equal`); the
    plain version timed by its one call."""
    from stark_tpu_torch.ops import blake2s as b2
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm
    from stark_tpu_torch.ops import ntt
    from stark_tpu_torch.protocol import fused_kernels as fk

    N, steps, MM = BIG_PRECISION, BIG_PRECISION // 8, MONT_MUL_OPS
    rng = np.random.default_rng(SEED + 23)
    g2 = spec.root_of_unity(N)
    big = ntt.NttPlan(spec, g2, N, "dit", device)
    small = ntt.NttPlan(spec, spec.inv(pow(g2, N // steps, spec.p)), steps, "dif", device)
    x_big = with_edges(spec, random_planes(rng, spec, N, device))
    x_small = with_edges(spec, random_planes(rng, spec, steps, device))
    transforms = (("dit", x_big, big), ("dif", x_small, small))
    out = {"butterfly_pass": compare(
        "butterfly_pass",
        lambda x, tw, l0, r, kind: ntt.butterfly_pass(spec, x, tw, l0, r, kind),
        lambda x, tw, l0, r, kind: ntt.butterfly_pass_plain(spec, x, tw, l0, r, kind),
        {f"big domain {kind} n={x.shape[1]} l0={l0} r={r}": (
            (x, tw, l0, r, kind), 2 * 64 * x.shape[1] + 4 * tw.numel(),
            r * x.shape[1] // 2 * MM)
         for kind, x, plan in transforms for l0, r, tw in plan.passes},
        reps=(5, 0))}
    out["butterfly_fused"] = compare(
        "butterfly_fused",
        lambda x, tw, block, kind: ntt.butterfly_fused(spec, x, tw, block, kind),
        lambda x, tw, block, kind: ntt.butterfly_fused_plain(spec, x, tw, block, kind),
        {f"big domain {kind} n={x.shape[1]} block={plan.block}": (
            (x, plan.fused_tw, plan.block, kind),
            2 * 64 * x.shape[1] + 4 * plan.fused_tw.numel(),
            (plan.block.bit_length() - 1) * x.shape[1] // 2 * MM)
         for kind, x, plan in transforms},
        reps=(5, 0))
    del big, small, x_small
    levels = {f"big domain n={N} level (16,{B},{C})": (B, C) for B, C in mm.scan_levels(N)}
    out["scan_prod"] = compare(
        "scan_prod",
        lambda x: fc.scan_prod(spec, x),
        lambda x: fc.scan_prod_plain(spec, x),
        {label: ((with_edges(spec, random_planes(rng, spec, B * C, device)).reshape(16, B, C),),
                 2 * 64 * B * C, B * C * MM, mm.scan_chain(B, C))
         for label, (B, C) in levels.items()},
        reps=(5, 0))
    for label, (B, C) in levels.items():
        out["scan_prod"]["cases"][label]["team"] = fc.scan_team(B, C)
    words = torch.zeros((64, N), dtype=torch.int32, device=device)
    out["from_mont_pack_words"] = compare(
        "from_mont_pack_words",
        lambda c: fk.from_mont_pack_words(spec, c, out=words[8:16]),
        lambda c: fk.from_mont_pack_words_plain(spec, c),
        {f"big domain n={N} into rows 8-15 of (64,{N})": (
            (x_big,), 64 * N + 32 * N, N * MM)},
        reps=(5, 0))
    del words, transforms, x_big
    leaves = random_words(rng, 64, N, device)
    out["blake2s_words"] = compare(
        "blake2s_words",
        b2.blake2s_words,
        b2.blake2s_words_plain,
        {f"big domain (64,{N}) 256-byte leaves": (
            (leaves, 256), 4 * (64 + 8) * N, 4 * N * BLAKE2S_OPS),
         f"big domain (16,{N // 2}) 64-byte nodes": (
             (random_words(rng, 16, N // 2, device), 64), 4 * (16 + 8) * (N // 2),
             N // 2 * BLAKE2S_OPS)},
        reps=(5, 0))
    for result in out.values():
        add_bounds(result, sm_hz)
    return out


def phase_big_domain(device) -> dict:
    """`squaring_chain(BIG_CONSTRAINTS)` at precision 2^23, the protocol's
    largest, proved cold (the stage set's build included) and warm, with
    every launch counter set to 0 before and read after each prove, its wall
    and `torch.cuda.max_memory_allocated` over each prove
    (`allocated_before`: what earlier phases still hold). The two proofs
    must be byte-identical, every kernel of the default route must launch in
    the cold prove, `fri_fold_dft` once a round (9), and the verifier must
    accept. Host seconds: the circuit's synthesis and its arithmetization.
    Then `fold_routes_at_size`: the same proof on the Lagrange fold route,
    and `squaring_chain(POSEIDON_BIG_CONSTRAINTS)` (precision 2^22) under
    digest="poseidon" on both routes."""
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.r1cs.synth import squaring_chain

    wrap = wrappers()
    t0 = time.time()
    r1cs, witness = squaring_chain(BIG_CONSTRAINTS)
    synthesis_s = time.time() - t0
    t0 = time.time()
    runner._static_arith(spec, r1cs)
    arith_s = time.time() - t0
    other = OFF_PATH + LAGRANGE_ONLY + CRT_ONLY + BITS_ONLY + POSEIDON_ONLY + SHOUP_ONLY
    wanted = [name for name in wrap if name not in other]
    runs, proofs = {}, []
    for run in ("cold", "warm"):
        for fn in wrap.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        proofs.append(runner.prove_with_witness(r1cs, witness, device=device))
        torch.cuda.synchronize()
        runs[run] = {"wall_s": time.time() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "allocated_before": before,
                     "launches": {name: fn.launches for name, fn in wrap.items()}}
    if proofs[1] != proofs[0]:
        raise AssertionError("the warm 2^23 proof differs from the cold one")
    missing = [name for name in wanted if runs["cold"]["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the 2^23 prove: {missing}")
    if len(proofs[0].fri_proof) - 1 != 9:
        raise AssertionError(f"the 2^23 proof has {len(proofs[0].fri_proof) - 1} FRI rounds")
    for run in runs:
        check_fold_launches(f"the {run} 2^23 prove", proofs[0],
                            runs[run]["launches"]["fri_fold_dft"])
    t0 = time.time()
    if not runner.verify_with_witness(r1cs, witness[:2], proofs[0], device=device,
                                      verify_cache=False):
        raise AssertionError("the verifier rejected the 2^23 proof")
    verify_s = time.time() - t0
    return {"constraints": BIG_CONSTRAINTS, "precision": BIG_PRECISION,
            "synthesis_s": synthesis_s, "arithmetization_s": arith_s,
            "verify_s": verify_s, **runs,
            "proof_sha256": hashlib.sha256(proof_mod.to_json(proofs[0]).encode()).hexdigest(),
            "fold_routes": fold_routes_at_size(device, r1cs, witness, proofs[0])}


def fold_routes_at_size(device, r1cs, witness, dft_proof) -> dict:
    """The 2^23 circuit on the Lagrange fold route, whose proof must equal
    the default route's `dft_proof`; then `squaring_chain(
    POSEIDON_BIG_CONSTRAINTS)` (precision 2^22) under digest="poseidon" on
    the default route, `fri_fold_dft` once a round (8), and on the Lagrange
    route, the two proofs byte-identical. Each prove's wall and
    `fri_fold_dft` launches."""
    from stark_tpu_torch.protocol import fused_kernels as fk
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.synth import squaring_chain

    def prove(what, r1cs, witness, fri_fold, digest="blake2s"):
        before = fk.fri_fold_dft.launches
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, witness, digest=digest, device=device,
                                          fri_fold=fri_fold)
        torch.cuda.synchronize()
        launches = fk.fri_fold_dft.launches - before
        check_fold_launches(what, proof, launches, fri_fold)
        out[what] = {"wall_s": time.time() - t0, "fri_rounds": len(proof.fri_proof) - 1,
                     "fri_fold_dft_launches": launches,
                     "proof_sha256": hashlib.sha256(
                         proof_mod.to_json(proof).encode()).hexdigest()}
        return proof

    out = {}
    if prove("2^23 lagrange", r1cs, witness, "lagrange") != dft_proof:
        raise AssertionError("the 2^23 proof on the Lagrange route differs from the default's")
    r1cs, witness = squaring_chain(POSEIDON_BIG_CONSTRAINTS)
    dft = prove("2^22 poseidon dft", r1cs, witness, "dft", "poseidon")
    if out["2^22 poseidon dft"]["fri_rounds"] != 8:
        raise AssertionError(f"the 2^22 proof has {out['2^22 poseidon dft']['fri_rounds']} "
                             f"FRI rounds")
    if prove("2^22 poseidon lagrange", r1cs, witness, "lagrange", "poseidon") != dft:
        raise AssertionError("the 2^22 Poseidon proof on the Lagrange route differs")
    return out


def phase_crt_kernels(spec, device, steps: int, precision: int) -> dict:
    """The three kernels of the CRT LDE engine against their plain versions,
    on the engine's tables for (steps, precision): `residues_in` and
    `matmul_fold` at the four products of one LDE (the big transform's step
    B first: the largest), `reconstruct` at both widths, and each at small
    ragged shapes that cross every tile edge. The digits and residues are
    those the engine makes from random field elements with 0 and p - 1 mixed
    in; `reconstruct` also gets columns of all-0 and all-(q - 1) residues."""
    from stark_tpu_torch.ops import crt, crt_cuda, mxu_ntt

    rng = np.random.default_rng(SEED + 1)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    t0 = time.time()
    inv, big = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision, device)
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    # (name, basis, plan, pre-table, B): x is (16, plan.k, B)
    steps_of_lde = [
        ("big B", big.basis_b, big.plan_b, big.twiddle, big.n1),
        ("big A", big.basis_a, big.plan_a, None, big.n2),
        ("inverse B", inv.basis_b, inv.plan_b, inv.twiddle, inv.n1),
        ("inverse A", inv.basis_a, inv.plan_a, None, inv.n2),
    ]
    small_basis = crt.CrtBasis(spec, 770)
    for kout, K, B in ((8, 8, 8), (5, 6, 5), (70, 100, 70), (130, 64, 36)):
        w = [[int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(K)]
             for _ in range(kout)]
        qs = np.asarray(small_basis.qs_host)[:, None, None]
        pre = rng.integers(0, qs, size=(len(small_basis.qs_host), K, B)).astype(np.int16)
        pre[:, 0, 0] = (qs - 1).astype(np.int16)[:, 0, 0]
        steps_of_lde.append((f"ragged kout={kout}", small_basis,
                             crt.CrtMatmulPlan(small_basis, w, device),
                             torch.from_numpy(pre).to(device), B))

    rin_cases, mm_cases, rec_cases = {}, {}, {}
    for name, basis, plan, pre, B in steps_of_lde:
        p1, K, kout = len(basis.qs_host), plan.k, plan.kout
        x = with_edges(spec, random_planes(rng, spec, K * B, device)).reshape(16, K, B)
        digit_bytes = 2 * 4 * p1 * -(-K // 4) * B
        tables = [] if pre is None else [(f"{name} (16,{K},{B}) pre, {p1} primes", pre)]
        if name != "inverse B":
            tables.append((f"{name} (16,{K},{B}), {p1} primes", None))
        for label, table in tables:
            rin_cases[label] = (
                (basis, x, table),
                64 * K * B + (2 * p1 * K * B if table is not None else 0) + digit_bytes,
                [(2 * 32 * p1 * K * B, INT8_TENSOR_OPS_PER_S),
                 (p1 * K * B * (7 + (6 if table is not None else 0)), INT_OPS_PER_S)],
            )
        x0, x1 = crt_cuda.residues_in(basis, x, pre)
        mm_cases[f"{name} {kout}x{K}x{B}, {p1} primes"] = (
            (basis, plan, x0, x1),
            2 * p1 * kout * K + digit_bytes + 4 * p1 * kout * B,
            8 * p1 * kout * K * B,
        )
        s = crt_cuda.matmul_fold(basis, plan, x0, x1).reshape(p1, kout * B).clone()
        qcol = torch.from_numpy(np.asarray(basis.qs_host, np.int32)).to(device)
        s[:, 0] = 0
        s[:, 1] = qcol - 1
        rec_cases[f"{name} ({p1},{kout * B})"] = (
            (basis, s), (4 * p1 + 64) * kout * B, (16 * p1 + 200) * kout * B,
        )

    def bmm_bf16(basis, plan, x0, x1):
        """The four digit products as library calls on bf16 copies of the
        digit planes (made here, outside the timed call)."""
        w = [t.to(torch.bfloat16) for t in (plan.W0, plan.W1)]
        x = [crt.unpack_k4(t, plan.k).to(torch.bfloat16) for t in (x0, x1)]
        return lambda: [torch.bmm(a, b) for a in w for b in x]

    out = {
        "residues_in": compare("residues_in", crt_cuda.residues_in,
                               crt_cuda.residues_in_plain, rin_cases, reps=(10, 1)),
        "matmul_fold": compare("matmul_fold", crt_cuda.matmul_fold,
                               crt_cuda.matmul_fold_plain, mm_cases, reps=(10, 1),
                               ops_per_s=INT8_TENSOR_OPS_PER_S, library_prep=bmm_bf16),
        "reconstruct": compare("reconstruct", crt_cuda.reconstruct,
                               crt_cuda.reconstruct_plain, rec_cases, reps=(10, 1)),
    }
    return out, tables_s


def _fixture(name: str):
    from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

    with open(os.path.join(FIXTURES, f"{name}.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIXTURES, f"{name}.wtns"), "rb") as f:
        witness = read_witness(f.read())
    return r1cs, witness


def prove_and_check(name, r1cs, witness, device, golden_text=None, golden_sha=None,
                    fri_fold="dft", lde_engine="butterfly", digest="blake2s"):
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import fused_kernels as fk
    from stark_tpu_torch.protocol import runner

    before = fk.fri_fold_dft.launches
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, witness, digest=digest, device=device,
                                      fri_fold=fri_fold, lde_engine=lde_engine)
    text = proof_mod.to_json(proof)
    prove_s = time.time() - t0
    check_fold_launches(name, proof, fk.fri_fold_dft.launches - before, fri_fold)
    if golden_text is not None and text != golden_text:
        raise AssertionError(f"{name}: proof JSON differs from the golden")
    sha = hashlib.sha256(text.encode()).hexdigest()
    if golden_sha is not None and sha != golden_sha:
        raise AssertionError(f"{name}: proof sha256 {sha} != golden {golden_sha}")
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    t0 = time.time()
    # every verify here makes its LDEs on its own engine: the cache is the
    # serve phase's to show
    if not runner.verify_with_witness(r1cs, witness[:n_pub], proof_mod.from_json(text),
                                      digest=digest, device=device, lde_engine=lde_engine,
                                      verify_cache=False):
        raise AssertionError(f"{name}: the verifier rejected the proof")
    return {"circuit": name, "digest": digest, "fri_fold": fri_fold,
            "lde_engine": lde_engine, "prove_s": prove_s,
            "verify_s": time.time() - t0, "proof_bytes": len(text), "sha256": sha}


def check_fold_launches(what: str, proof, launches: int, fri_fold: str = "dft") -> None:
    """`fri_fold_dft` launches once a round of the proof's FRI on the default
    route and never on the Lagrange route."""
    want = len(proof.fri_proof) - 1 if fri_fold == "dft" else 0
    if launches != want:
        raise AssertionError(f"{what}: fri_fold_dft launched {launches} times on the "
                             f"{fri_fold} route, not {want}")


class _Forward:
    """Stands in for a module: its own attributes first, then the module's."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)


def timed_wrappers(module, names, width):
    """Wrap `module`'s functions `names` so that each call records CUDA events
    around its launches and `width(name, args)`, a size of its operands;
    returns ({name: [(start, end, width)]}, a function that restores them)."""
    spans = {name: [] for name in names}
    originals = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            result = fn(*args)
            end.record()
            spans[name].append((start, end, width(name, args)))
            return result
        return timed

    for name in names:
        setattr(module, name, wrap(name, originals[name]))
    return spans, lambda: [setattr(module, n, fn) for n, fn in originals.items()]


def prove_bits_first(circuit, device, want, fri_fold, lde_engine) -> dict:
    """The `bits` golden's first (cold) prove with every launch counter set to
    0 just before and read just after, and the device time of the calls of
    `BITS_TIMED` in it: the path of `BITS_ONLY`, which must launch."""
    from stark_tpu_torch.protocol import kernels

    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    # the width of the small operand: the coefficients or the points
    spans, restore = timed_wrappers(
        kernels, BITS_TIMED,
        lambda name, args: args[1 if name == "horner_eval" else 2].shape[1])
    try:
        rec = prove_and_check("bits", *circuit, device, golden_text=want,
                              fri_fold=fri_fold, lde_engine=lde_engine)
    finally:
        restore()
    torch.cuda.synchronize()
    rec["launches"] = {name: fn.launches for name, fn in wrap.items()}
    rec["kernels_ms"] = {name: [{"terms": count, "ms": start.elapsed_time(end)}
                                for start, end, count in calls]
                         for name, calls in spans.items()}
    missing = [name for name in BITS_ONLY + BITS_TIMED if rec["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the bits prove: {missing}")
    return rec


def phase_goldens(device) -> list[dict]:
    from stark_tpu_torch.r1cs.synth import ragged_mix

    out = []
    for name, golden, routes in GOLDENS:
        with open(os.path.join(FIXTURES, golden)) as f:
            want = f.read()
        circuit = _fixture(name)
        for k, (fri_fold, lde_engine) in enumerate(routes):
            if name == "bits" and k == 0:
                out.append(prove_bits_first(circuit, device, want, fri_fold, lde_engine))
                continue
            out.append(prove_and_check(name, *circuit, device, golden_text=want,
                                       fri_fold=fri_fold, lde_engine=lde_engine))
    with open(os.path.join(FIXTURES, "ragged120_proof_sha256.txt")) as f:
        sha = f.read().strip()
    out.append(prove_and_check("ragged_mix(120)", *ragged_mix(120), device, golden_sha=sha))
    out.extend(poseidon_goldens(device))
    return out


def poseidon_goldens(device) -> list[dict]:
    """The `compute` proof under digest="poseidon" on both fold routes of the
    butterfly engine, byte for byte the committed Poseidon golden and
    verified; the blake2s verifier must reject it."""
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    with open(os.path.join(FIXTURES, POSEIDON_GOLDEN)) as f:
        want = f.read()
    r1cs, witness = _fixture("compute")
    out = [prove_and_check("compute", r1cs, witness, device, golden_text=want,
                           fri_fold=fri_fold, lde_engine=lde_engine, digest="poseidon")
           for fri_fold, lde_engine in BUTTERFLY_ROUTES]
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    try:
        runner.verify_with_witness(r1cs, witness[:n_pub], proof_mod.from_json(want),
                                   device=device)
    except (ValueError, AssertionError) as e:
        out[-1]["blake2s_verify_refused"] = f"{type(e).__name__}: {e}"[:200]
    else:
        raise AssertionError("the blake2s verifier accepted the Poseidon golden")
    return out


def phase_real(device, r1cs, witness, profile: bool, lde_engine: str = "butterfly",
               want_proof=None, digest: str = "blake2s"):
    """Cold and warm prove plus verify at full size on the default fold
    route, the named LDE engine and tree digest, with every kernel's launch
    count in each proving run; the proof must equal `want_proof` where one
    is given. Under digest="poseidon" the warm prove also records the device
    time of each Poseidon launch (`poseidon_ms`: CUDA events around the
    wrappers), the hashes of each kernel and their operations bound. Returns the record, with the proof's sha256 to compare across
    builds, and the proof."""
    from stark_tpu_torch.merkle import tree as mt
    from stark_tpu_torch.ops import poseidon as pos
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    wrap = wrappers()
    crt = lde_engine == "crt"
    poseidon = digest == "poseidon"

    def timed_prove():
        for fn in wrap.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, witness, digest=digest, device=device,
                                          lde_engine=lde_engine)
        seconds = time.time() - t0
        launches = {name: fn.launches for name, fn in wrap.items()}
        return proof, seconds, launches, torch.cuda.max_memory_allocated()

    proof, cold_s, launches, peak_cold = timed_prove()
    check_fold_launches("the cold real-size prove", proof, launches["fri_fold_dft"])
    # the butterfly engine's run must launch every kernel but the other
    # routes' (the Poseidon pair only under that digest); the CRT engine's,
    # which finds the circuit's tables made, its three
    other = (OFF_PATH + LAGRANGE_ONLY + CRT_ONLY + BITS_ONLY + SHOUP_ONLY
             + (() if poseidon else POSEIDON_ONLY))
    wanted = CRT_ONLY if crt else [name for name in wrap if name not in other]
    missing = [name for name in wanted if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the proving run: {missing}")
    if want_proof is not None and proof != want_proof:
        raise AssertionError(f"the {lde_engine} engine's proof differs from the expected one")
    if poseidon:
        # time the trees' calls where `merkle/tree.py` makes them: through a
        # stand-in for the module, so that each wrapper still counts its own
        # launches
        view = _Forward(pos)
        spans, _ = timed_wrappers(view, POSEIDON_ONLY, lambda name, args: args[0].shape[1])
        mt.pos = view
    try:
        proof_warm, warm_s, launches_warm, peak_warm = timed_prove()
    finally:
        mt.pos = pos
    if proof_warm != proof:
        raise AssertionError("warm proof differs from the cold proof")
    check_fold_launches("the warm real-size prove", proof, launches_warm["fri_fold_dft"])
    t0 = time.time()
    if not runner.verify_with_witness(r1cs, witness[:2], proof, digest=digest, device=device,
                                      lde_engine=lde_engine, verify_cache=False):
        raise AssertionError("the verifier rejected the real-size proof")
    verify_s = time.time() - t0
    out = {
        "lde_engine": lde_engine, "digest": digest,
        "constraints": r1cs.header.n_constraints, "prove_cold_s": cold_s,
        "prove_warm_s": warm_s, "verify_s": verify_s,
        "peak_bytes_cold": peak_cold, "peak_bytes_warm": peak_warm,
        "launches": launches, "launches_warm": launches_warm,
        "proof_sha256": hashlib.sha256(proof_mod.to_json(proof).encode()).hexdigest(),
    }
    if poseidon:
        torch.cuda.synchronize()
        calls = [(name, start.elapsed_time(end), width)
                 for name, group in spans.items() for start, end, width in group]
        hashes = {name: sum(width if name == "poseidon_leaves" else width // 2
                            for n, _, width in calls if n == name) for name in POSEIDON_ONLY}
        out["poseidon_ms"] = {
            "total": sum(ms for _, ms, _ in calls),
            "launches": len(calls),
            "hashes": hashes,
            "bound_ms": (hashes["poseidon_leaves"] * poseidon_ops(POSEIDON_LEAF_PRODUCTS)
                         + hashes["poseidon_pairs"] * poseidon_ops(POSEIDON_PAIR_PRODUCTS))
            / INT_OPS_PER_S * 1e3,
            "lane_form_launches": sum(
                pos.lane_form(width if name == "poseidon_leaves" else width // 2)
                for name, _, width in calls),
            "calls": [{"kernel": name, "input_width": width, "ms": ms}
                      for name, ms, width in calls],
        }
    if profile:
        out["profile"] = {
            "crt" if crt else fri_fold:
                profile_warm_prove(r1cs, witness, device, proof, fri_fold, lde_engine, digest)
            for fri_fold in (("dft",) if crt or poseidon else ("dft", "lagrange"))}
    return out, proof


def phase_lde_engines(spec, device, params) -> dict:
    """The 9-column `lde_many` stage of both engines on the same random
    Montgomery traces, in turns (butterfly, crt, crt, butterfly): equal
    outputs, and the synced wall and device time of each run."""
    from stark_tpu_torch import device as devmod
    from stark_tpu_torch.protocol import prove

    rng = np.random.default_rng(SEED + 2)
    traces = [random_planes(rng, spec, params.steps, device) for _ in range(9)]
    stages = {engine: prove._stages_cached(
        spec, params.steps, params.precision, params.original_steps, "blake2s",
        devmod.resolve(device), engine) for engine in ("butterfly", "crt")}
    runs, want = [], None
    for engine in ("butterfly", "crt", "crt", "butterfly"):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        start.record()
        outs = stages[engine]["lde_many"](traces)
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        want = want or outs
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError(f"lde_many on the {engine} engine differs from the first run")
        runs.append({"lde_engine": engine, "wall_s": wall,
                     "device_ms": start.elapsed_time(end),
                     "peak_bytes": torch.cuda.max_memory_allocated()})
        del outs
    return {"columns": len(traces), "runs": runs}


def device_busy_ms(fn, reps: int = 5, tries: int = 3):
    """Device time of a call of fn: the union of the intervals of its
    kernels and copies under torch.profiler, the card's idle gaps left out,
    over `reps` calls in one profiled window, a call's share. A window in
    which the profiler delivered no device event at all (it has happened
    to a short one) is profiled again; after `tries` such windows the time
    is None (not measured), since fn's values are checked elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
                 if str(ev.device_type).endswith("CUDA")]
        if spans:
            return profiling.union_length(spans) / 1e3 / reps
    return None


def profile_warm_prove(r1cs, witness, device, want_proof, fri_fold,
                       lde_engine="butterfly", digest="blake2s") -> dict:
    """On one fold route and LDE engine: a warm-up prove, `torch.profiler`
    over one warm prove, then two warm proves with a device synchronise after
    every stage for the stages' wall times."""
    from torch.profiler import ProfilerActivity, profile

    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.utils import profiling

    route = {"device": device, "fri_fold": fri_fold, "lde_engine": lde_engine,
             "digest": digest}
    runner.prove_with_witness(r1cs, witness, **route)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.prove_with_witness(r1cs, witness, **route)
        torch.cuda.synchronize()
    profiled_s = time.time() - t0
    kernels, copies, spans = {}, {"count": 0, "us": 0.0}, []
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            us = ev.time_range.elapsed_us()
            spans.append((ev.time_range.start, ev.time_range.end))
            if ev.name.startswith("Memcpy") or ev.name.startswith("Memset"):
                copies["count"] += 1
                copies["us"] += us
            else:
                k = kernels.setdefault(ev.name, {"count": 0, "us": 0.0})
                k["count"] += 1
                k["us"] += us
    busy_us = profiling.union_length(spans)
    span_us = max(hi for _, hi in spans) - min(lo for lo, _ in spans)
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:25]
    hand = {}
    for name, k in kernels.items():
        short = profiling.hand_kernel_name(name)
        if short is not None:
            h = hand.setdefault(short, {"count": 0, "us": 0.0})
            h["count"] += k["count"]
            h["us"] += k["us"]
    result = {
        "profiled_prove_s": profiled_s, "device_busy_us": busy_us,
        "device_span_us": span_us, "device_busy_share": busy_us / span_us,
        "kernel_launches": sum(k["count"] for k in kernels.values()),
        "kernel_us": sum(k["us"] for k in kernels.values()),
        "copies": copies,
        "hand_kernels": hand, "hand_kernel_us": sum(h["us"] for h in hand.values()),
        "top_kernels": [{"name": n[:120], **k} for n, k in top],
    }

    result["stage_wall_s"] = stage_walls(r1cs, witness, device, want_proof, fri_fold,
                                         lde_engine, digest)
    return result


def stage_walls(r1cs, witness, device, want_proof, fri_fold, lde_engine="butterfly",
                digest="blake2s", runs: int = 2) -> list[dict]:
    """Wall seconds of each of the program's top-level phases (`utils/
    tracing.py`: arithmetize, traces, a_tree, columns, commits, branches,
    fri, materialize) over `runs` warm proves, each phase ending in a device
    synchronise, with the peak memory within each (`peak_bytes`:
    `profiling.phase_memory_peaks`); "rest" is the prove's wall outside
    the phases."""
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.utils import profiling, tracing

    out = []
    for _ in range(runs):
        tracing.reset()
        torch.cuda.synchronize()
        t0 = time.time()
        peaks, proof = profiling.phase_memory_peaks(
            lambda: runner.prove_with_witness(r1cs, witness, digest=digest, device=device,
                                              fri_fold=fri_fold, lde_engine=lde_engine),
            device)
        total = time.time() - t0
        if proof != want_proof:
            raise AssertionError("a phase-timed proof differs from the cold proof")
        walls = profiling.phase_walls()
        out.append({**walls, "rest": total - sum(walls.values()), "total": total,
                    "peak_bytes": peaks})
    tracing.reset()
    return out


def file_route_stages(r1cs_path: str, wtns_path: str, proof_path: str, device,
                      route: str) -> tuple[dict, str]:
    """One prove of a circuit's files through the runner's pieces, stage by
    stage, each stage's host wall: on the native route (`runner.read_circuit`
    and `runner.read_witness_rows`, the C++ readers, whose witness parse
    gives the rows) or on the Python route (`read_r1cs`, `read_witness`,
    `runner._witness_rows`: the file route before the C++ readers took it),
    then the static arithmetization of the parsed circuit, the prove from
    the rows and the JSON write. Returns the walls and the JSON."""
    from stark_tpu_torch import native
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

    walls = {"route": route}

    def stage(name, fn):
        t0 = time.time()
        value = fn()
        walls[f"{name}_s"] = time.time() - t0
        return value

    if route == "native":
        circuit = stage("parse_r1cs", lambda: runner.read_circuit(r1cs_path))
        if not isinstance(circuit, native.FlatR1cs):
            raise AssertionError("the runner did not read the circuit on the native route")
        rows = stage("parse_wtns", lambda: runner.read_witness_rows(wtns_path, circuit))
        walls["witness_rows_s"] = 0.0  # the C++ reader's output is the rows
    else:
        circuit = stage("parse_r1cs", lambda: read_r1cs(runner._read(r1cs_path)))
        witness = stage("parse_wtns", lambda: read_witness(runner._read(wtns_path)))
        rows = stage("witness_rows", lambda: runner._witness_rows(circuit, witness))
    stage("arithmetize", lambda: runner._static_arith(runner._spec_for(circuit), circuit))
    proof = stage("prove", lambda: runner.prove_with_rows(circuit, rows, device=device))
    text = stage("json_write", lambda: runner.write_proof(proof, proof_path))
    walls["host_s"] = sum(v for k, v in walls.items() if k.endswith("_s") and k != "prove_s")
    return walls, text


def phase_file_route(device, r1cs, witness, want_proof) -> dict:
    """The file-path entry points on the native route (see the module
    docstring, phase 5b)."""
    from stark_tpu_torch import cli, native
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.r1cs.synth import write_circuit_files

    # on the card's machine the route must run: no quiet fall back to the
    # Python readers where g++ is missing
    if not native.available():
        raise AssertionError("the host library did not build: no native file route")
    wrap = wrappers()
    want_json = proof_mod.to_json(want_proof)
    out = {}

    def cli_main(*argv):
        printed = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli.main([*argv, "--device", device])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} returned {rc}")
        return {"wall_s": time.time() - t0, "printed": printed.getvalue().splitlines()}

    def read(path):
        with open(path) as f:
            return f.read()

    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, name)
                 for name in ("chain.r1cs", "chain.wtns", "cli.json", "run.json",
                              "stages.json", "child.json")}
        t0 = time.time()
        write_circuit_files(r1cs, witness, paths["chain.r1cs"], paths["chain.wtns"])
        out["write_files_s"] = time.time() - t0
        out["file_bytes"] = {name: os.path.getsize(paths[name])
                             for name in ("chain.r1cs", "chain.wtns")}
        files = (paths["chain.r1cs"], paths["chain.wtns"])

        # the CLI's prove, every launch counter from 0
        for fn in wrap.values():
            fn.launches = 0
        torch.cuda.synchronize()
        out["cli prove"] = cli_main("prove", *files, paths["cli.json"])
        launches = {name: fn.launches for name, fn in wrap.items()}
        if read(paths["cli.json"]) != want_json:
            raise AssertionError("the native file route's proof differs from the real-size one")
        other = (OFF_PATH + LAGRANGE_ONLY + CRT_ONLY + BITS_ONLY + SHOUP_ONLY + POSEIDON_ONLY)
        missing = [name for name in wrap if name not in other and launches[name] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the file route's prove: {missing}")
        out["launches"] = launches
        out["cli verify"] = cli_main("verify", *files, paths["cli.json"])
        out["cli run"] = cli_main("run", *files, paths["run.json"])
        if read(paths["run.json"]) != want_json:
            raise AssertionError("the CLI's run wrote another proof")

        # stage by stage, both routes, in turns
        out["stages"] = []
        for route in ("python", "native", "native", "python"):
            walls, text = file_route_stages(*files, paths["stages.json"], device, route)
            if text != want_json:
                raise AssertionError(f"the {route} route's proof differs from the real-size one")
            out["stages"].append(walls)

        # fresh processes: the CLI's warmup, then its prove
        out["fresh"] = {}
        for name, argv in (("warmup", ["warmup", files[0]]),
                           ("prove", ["prove", *files, paths["child.json"]])):
            t0 = time.time()
            done = subprocess.run([sys.executable, "-m", "stark_tpu_torch.cli", *argv,
                                   "--device", device], cwd=ROOT, capture_output=True,
                                  text=True, timeout=300)
            if done.returncode != 0:
                raise AssertionError(f"cli {name} in a fresh process: {done.stderr[-2000:]}")
            out["fresh"][name] = {"wall_s": time.time() - t0,
                                  "printed": done.stdout.splitlines()}
        if read(paths["child.json"]) != want_json:
            raise AssertionError("the fresh process's proof differs from the real-size one")
    return out


def phase_tracing(device, r1cs, witness, want_proof) -> dict:
    """The program's phases on the default route at 2^20 (phase 5c, see the
    module docstring). Every proof must equal `want_proof`, and no traced
    prove may reset the peak memory (`reset_peak_memory_stats` is counted
    around them)."""
    from stark_tpu_torch import device as devmod
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.protocol import prove, runner
    from stark_tpu_torch.protocol.params import derive_params
    from stark_tpu_torch.utils import profiling, tracing

    dev = devmod.resolve(device)
    resets = []
    real_reset = torch.cuda.reset_peak_memory_stats

    def counted_reset(*args, **kwargs):
        resets.append(1)
        return real_reset(*args, **kwargs)

    def traced(wrap=None, **switches):
        previous = tracing.configure(**switches)
        tracing.reset()
        torch.cuda.reset_peak_memory_stats = counted_reset
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            with wrap if wrap is not None else contextlib.nullcontext():
                proof = runner.prove_with_witness(r1cs, witness, device=device)
            wall = time.time() - t0
        finally:
            torch.cuda.reset_peak_memory_stats = real_reset
            tracing.configure(**previous)
        if proof != want_proof:
            raise AssertionError(f"a prove under {switches} differs from phase 5's")
        return wall

    out = {"off_s": [traced() for _ in range(3)]}
    report = io.StringIO()
    out["trace_s"] = [traced(trace=True, out=report) for _ in range(2)]
    synced = []
    for _ in range(2):
        wall = traced(trace=True, sync_phases=True, out=report)
        walls = profiling.phase_walls()
        synced.append({"wall_s": wall, "phases_s": walls, "sum_s": sum(walls.values()),
                       "share": sum(walls.values()) / wall})
    out["synced"] = synced
    out["report"] = report.getvalue().splitlines()[-len(walls):]
    if any(rec["share"] < 1 - TRACED_OUTSIDE for rec in synced):
        raise AssertionError(f"the synced prove's top-level phases hold less than "
                             f"{1 - TRACED_OUTSIDE:.0%} of its wall: {synced}")
    with tempfile.TemporaryDirectory() as profile_dir:
        out["profiled_s"] = traced(wrap=tracing.phase("profiled_prove", device=dev),
                                   profile_dir=profile_dir, sync_phases=True)
        names = [name for name in tracing.exit_log() if name != "profiled_prove"]
        timeline = profiling.parse_device_trace(profile_dir, names)
        timeline["trace_bytes"] = os.path.getsize(os.path.join(profile_dir, timeline["trace"]))
    busy = timeline["device_busy_s"]
    split = timeline["phase_device_s"]
    if not busy or abs(sum(split.values()) - busy) > 1e-9 * (len(split) + 1):
        raise AssertionError(f"the phases' device seconds do not sum to the busy time: "
                             f"{split} against {busy}")
    timeline["phase_device_ms"] = {k: v * 1e3 for k, v in split.items()}
    timeline["busy_share_of_profiled_prove"] = busy / out["profiled_s"]
    timeline["busy_share_of_warm_prove"] = busy / statistics.median(out["off_s"])
    timeline["hand_kernel_share_of_busy"] = timeline["hand_kernel_s"] / busy
    out["device_timeline"] = timeline
    if resets:
        raise AssertionError(f"a traced prove reset the peak memory {len(resets)} times")
    arith = runner._static_arith(spec, r1cs)
    params = derive_params(spec, arith.original_steps)
    stages = prove._stages_cached(spec, params.steps, params.precision, arith.original_steps,
                                  "blake2s", dev, "butterfly")
    out["resident_bytes"] = stages["resident_bytes"]()
    tracing.reset()
    peaks, proof = profiling.phase_memory_peaks(
        lambda: runner.prove_with_witness(r1cs, witness, device=device), device)
    if proof != want_proof:
        raise AssertionError("the peaks' prove differs from phase 5's")
    out["peak_bytes"] = peaks
    tracing.reset()
    return out


def phase_serve(device, r1cs, witness, want_proof, want_poseidon) -> dict:
    """The proving worker on the Lagrange fold route, then `prove_many`
    (see the module docstring, phase 6)."""
    from stark_tpu_torch import serve
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.synth import squaring_chain, write_circuit_files

    wrap = wrappers()
    want_json = proof_mod.to_json(want_proof)
    counts = lambda: {name: fn.launches for name, fn in wrap.items()}  # noqa: E731
    snapshots = []

    with tempfile.TemporaryDirectory() as tmp:
        files = {"r1cs": os.path.join(tmp, "chain.r1cs"), "wtns": os.path.join(tmp, "chain.wtns")}
        proof_path = os.path.join(tmp, "proof.json")
        poseidon = {"digest": "poseidon", "proof_json": os.path.join(tmp, "poseidon.json")}
        write_circuit_files(r1cs, witness, files["r1cs"], files["wtns"])
        requests = [
            {"id": 1, "method": "ping"},
            {"id": 2, "method": "warmup", "params": {"r1cs": files["r1cs"]}},
            {"id": 3, "method": "prove", "params": {**files, "inline": True}},
            {"id": 4, "method": "prove", "params": {**files, "proof_json": proof_path}},
            {"id": 5, "method": "prove", "params": {**files, **poseidon, "inline": True}},
            # the circuit's first verify makes its 6 public-column LDEs, the
            # next ones find them on the worker's cached circuit
            {"id": 6, "method": "verify", "params": {**files, **poseidon}},
            {"id": 7, "method": "verify", "params": {**files, **poseidon}},
            {"id": 8, "method": "verify", "params": {**files, "proof_json": proof_path}},
            {"id": 9, "method": "frobnicate"},
            {"id": 10, "method": "ping"},
            {"id": 11, "method": "shutdown"},
        ]

        def feed():
            # the worker answers a request before it reads the next line
            for req in requests:
                torch.cuda.synchronize()
                snapshots.append((counts(), time.time()))
                yield json.dumps(req) + "\n"

        replies_io = io.StringIO()
        for fn in wrap.values():
            fn.launches = 0
        rc = serve.serve(feed(), replies_io, device=device, fri_fold="lagrange")
        torch.cuda.synchronize()
        snapshots.append((counts(), time.time()))
        launches = counts()
        with open(proof_path) as f:
            proof_file = f.read()

    lines = replies_io.getvalue().splitlines()
    if rc != 0 or not all(ln.startswith("RPC ") for ln in lines):
        raise AssertionError(f"the worker returned {rc} or wrote a line without the RPC prefix")
    replies = [json.loads(ln[4:]) for ln in lines]
    if replies[0] != {"id": None, "result": {"ok": True, "event": "ready"}}:
        raise AssertionError(f"no ready event: {lines[0][:200]}")
    by_id = {r["id"]: r for r in replies[1:]}
    if sorted(by_id) != [r["id"] for r in requests]:
        raise AssertionError(f"replies for {sorted(by_id)}, requests {len(requests)}")
    for i in (1, 2, 3, 4, 5, 6, 7, 8, 10, 11):
        if not by_id[i].get("result", {}).get("ok"):
            raise AssertionError(f"request {i} failed: {json.dumps(by_id[i])[:500]}")
    if by_id[9].get("error", {}).get("type") != "ValueError":
        raise AssertionError(f"the unknown method was not refused: {by_id[9]}")
    if by_id[3]["result"]["proof"] != want_json or proof_file != want_json:
        raise AssertionError("the worker's Lagrange-route proof differs from the DFT route's")
    if by_id[5]["result"]["proof"] != proof_mod.to_json(want_poseidon):
        raise AssertionError("the worker's Poseidon proof differs from the real-size one")
    for i in (6, 7, 8):
        if by_id[i]["result"].get("verified") is not True:
            raise AssertionError(f"the worker's verifier rejected the proof of request {i}")
    per_request = {}
    for req, (before, t_before), (after, t_after) in zip(requests, snapshots, snapshots[1:]):
        per_request[f"{req['id']} {req['method']}"] = {
            "seconds": t_after - t_before,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    for key in ("3 prove", "4 prove", "5 prove"):
        for name in LAGRANGE_ONLY:
            if per_request[key]["launches"].get(name, 0) <= 0:
                raise AssertionError(f"{name} was not launched by request {key}")
        for name in DFT_ONLY:
            if per_request[key]["launches"].get(name, 0):
                raise AssertionError(f"{name} was launched by request {key} on lagrange")
    for name in POSEIDON_ONLY:
        if per_request["5 prove"]["launches"].get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched by the Poseidon prove")
    # the LDE's kernels in each verify: the first makes the 6 columns' LDEs,
    # the later ones must find them cached
    lde = {key: sum(per_request[key]["launches"].get(name, 0) for name in LDE_KERNELS)
           for key in ("6 verify", "7 verify", "8 verify")}
    if lde["6 verify"] <= 0 or lde["7 verify"] or lde["8 verify"]:
        raise AssertionError(f"LDE launches of the verifies, the first alone should have "
                             f"some: {lde}")
    missing = [name for name, n in launches.items()
               if n <= 0 and name not in OFF_PATH + CRT_ONLY + BITS_ONLY + SHOUP_ONLY + DFT_ONLY]
    if missing:
        raise AssertionError(f"kernels not launched by the worker's run: {missing}")

    # prove_many against a loop of single proves, each way twice, in turns
    witnesses = [squaring_chain(r1cs.header.n_constraints, x0=x0)[1] for x0 in PROVE_MANY_X0]

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proofs = fn()
        torch.cuda.synchronize()
        return proofs, time.time() - t0, torch.cuda.max_memory_allocated()

    loop = lambda: [runner.prove_with_witness(r1cs, w, device=device, fri_fold="lagrange")  # noqa: E731
                    for w in witnesses]
    many = lambda: runner.prove_many(r1cs, witnesses, pipeline=2, device=device,  # noqa: E731
                                     fri_fold="lagrange")
    runs = []
    singles = None
    for way, fn in (("loop", loop), ("prove_many", many), ("prove_many", many), ("loop", loop)):
        proofs, seconds, peak = timed(fn)
        singles = singles or proofs
        if proofs != singles:
            raise AssertionError(f"{way}: a proof differs from the first loop's")
        runs.append({"way": way, "seconds": seconds, "proofs_per_s": len(proofs) / seconds,
                     "peak_bytes": peak})
    if singles[0] != want_proof or len({proof_mod.to_json(p) for p in singles}) != len(singles):
        raise AssertionError("the pipelined witnesses' proofs are not the expected ones")
    return {"fri_fold": "lagrange", "launches": launches, "requests": per_request,
            "verify_lde_launches": lde,
            "prove_many": {"witnesses": len(witnesses), "pipeline": 2, "runs": runs}}


def worker_on_crt(device, r1cs, witness, want_proof) -> dict:
    """A second worker, started with `lde_engine="crt"`: warmup and one
    inline prove, whose proof must equal `want_proof` and whose run must
    launch the engine's three kernels, then shutdown."""
    from stark_tpu_torch import serve
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.r1cs.synth import write_circuit_files

    wrap = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        files = {"r1cs": os.path.join(tmp, "chain.r1cs"), "wtns": os.path.join(tmp, "chain.wtns")}
        write_circuit_files(r1cs, witness, files["r1cs"], files["wtns"])
        requests = [
            {"id": 1, "method": "warmup", "params": {"r1cs": files["r1cs"]}},
            {"id": 2, "method": "prove", "params": {**files, "inline": True}},
            {"id": 3, "method": "shutdown"},
        ]
        replies_io = io.StringIO()
        for fn in wrap.values():
            fn.launches = 0
        t0 = time.time()
        rc = serve.serve(io.StringIO("".join(json.dumps(r) + "\n" for r in requests)),
                         replies_io, device=device, lde_engine="crt")
        torch.cuda.synchronize()
        seconds = time.time() - t0
    replies = [json.loads(ln[4:]) for ln in replies_io.getvalue().splitlines()]
    by_id = {r["id"]: r for r in replies[1:]}
    if rc != 0 or sorted(by_id) != [1, 2, 3] or not all(
            by_id[i].get("result", {}).get("ok") for i in (1, 2, 3)):
        raise AssertionError(f"the crt worker failed: {json.dumps(replies)[:500]}")
    if by_id[2]["result"]["proof"] != proof_mod.to_json(want_proof):
        raise AssertionError("the crt worker's proof differs from the default engine's")
    launches = {name: wrap[name].launches for name in CRT_ONLY}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the crt worker did not launch its kernels: {launches}")
    return {"seconds": seconds, "prove_s": by_id[2]["result"]["seconds"], "launches": launches}


def mesh_kernels() -> list[str]:
    """The kernels the mesh's default route must launch in every rank."""
    off = (OFF_PATH + LAGRANGE_ONLY + CRT_ONLY + BITS_ONLY + POSEIDON_ONLY + MESH_OFF
           + SHOUP_ONLY)
    return [name for name in KERNELS if name not in off]


def mesh_rank(mesh, constraints: int, routes, crt: bool = False,
              lde_case: bool = False) -> dict:
    """One rank of a mesh prove (a `distributed.run_ranks` child): a fresh
    `squaring_chain(constraints)` proved cold and warm on the defaults, then
    once on each (fri_fold, digest) of `routes`. Every launch counter is set
    to 0 just before the cold prove and the warm one and read just after
    each. Each prove records its wall (it ends with the proof on the host),
    the rank's `max_memory_allocated` over it, the collectives' calls, bytes
    and synced seconds (`mesh.stats`) and the proof's sha256; rank 0 also
    returns the cold proof's JSON. With `crt`, the rank first builds its two
    local DFTs' CRT plans (`crt_table_build_s`; its cache is `PLAN_CACHE`,
    which the ranks share), then proves cold and warm with
    `lde_engine="crt"`, counted the same way, each prove's collectives' bytes
    equal to the butterfly prove's; with `lde_case`, `mesh_lde_case`."""
    from stark_tpu_torch.ops import mxu_ntt, plan_cache
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.synth import squaring_chain

    plan_cache.CACHE_DIR = PLAN_CACHE
    t0 = time.time()
    r1cs, witness = squaring_chain(constraints)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "staged": mesh.staged, "synthesis_s": time.time() - t0}
    wrap = wrappers()

    def prove(fri_fold="dft", digest="blake2s", lde_engine="butterfly"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_stats()
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, witness, mesh=mesh, digest=digest,
                                          device=mesh.device, fri_fold=fri_fold,
                                          lde_engine=lde_engine)
        wall = time.time() - t0
        text = proof_mod.to_json(proof)
        return {"wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated(),
                "collectives": mesh.stats,
                "proof_sha256": hashlib.sha256(text.encode()).hexdigest()}, text

    def counted(**kw):
        for fn in wrap.values():
            fn.launches = 0
        rec, text = prove(**kw)
        rec["launches"] = {name: fn.launches for name, fn in wrap.items()}
        return rec, text

    out["cold"], text = counted()
    out["warm"], _ = counted()
    for fri_fold, digest in routes:
        out[f"{fri_fold}, {digest}"], _ = prove(fri_fold, digest)
    if crt:
        from stark_tpu_torch.fields.field import BN254_FR as spec
        from stark_tpu_torch.protocol.params import derive_params

        params = derive_params(spec, 3 * constraints)
        g2 = spec.root_of_unity(params.precision)
        g1 = pow(g2, params.precision // params.steps, spec.p)
        d, p = mesh.size, spec.p
        t0 = time.time()
        for root, m in ((pow(spec.inv(g1), d, p), params.steps // d),
                        (pow(g2, d, p), params.precision // d)):
            mxu_ntt.make_ntt_plan_cached(spec, root, m, mesh.device)
        out["crt_table_build_s"] = time.time() - t0
        for key in ("cold", "warm"):
            rec, _ = counted(lde_engine="crt")
            bytes_of = lambda r: {k: v["bytes"] for k, v in r["collectives"].items()}  # noqa: E731
            if bytes_of(rec) != bytes_of(out[key]):
                raise AssertionError(f"rank {mesh.rank} crt {key}: collectives' bytes "
                                     f"{bytes_of(rec)} != the butterfly prove's "
                                     f"{bytes_of(out[key])}")
            out[f"crt {key}"] = rec
    if lde_case:
        out["lde_mxu_sharded"] = mesh_lde_case(mesh, wrap)
    if mesh.rank == 0:
        out["proof"] = text
    return out


def mesh_lde_case(mesh, wrap) -> dict:
    """`mxu_ntt.lde_mxu_sharded` of a (16, 2^17) column to 2^20
    (`MESH_LDE_STEPS`, `MESH_LDE_PRECISION`) from the rank's chunk (every rank draws the same column from one seed), against
    the rank's chunk of `lde_mxu` on one device (`torch.equal`); its wall
    (synced: the collectives sync), collectives, the CRT kernels' launches,
    and the single-device LDE's device time beside it."""
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import mxu_ntt

    steps, precision = MESH_LDE_STEPS, MESH_LDE_PRECISION
    d, r = mesh.size, mesh.rank
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    plans = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision, mesh.device)
    trace = random_planes(np.random.default_rng(SEED + 14), spec, steps, mesh.device)
    local = trace[:, r * steps // d : (r + 1) * steps // d].contiguous()
    mesh.reset_stats()  # a fresh dict: the proves' records keep theirs
    mxu_ntt.lde_mxu_sharded(mesh, *plans, local)  # warm
    for fn in wrap.values():
        fn.launches = 0
    mesh.reset_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    got = mxu_ntt.lde_mxu_sharded(mesh, *plans, local)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: wrap[name].launches for name in CRT_ONLY}
    want = mxu_ntt.lde_mxu(*plans, trace)
    m = precision // d
    return {"equal": bool(torch.equal(got, want[:, r * m : (r + 1) * m])), "wall_s": wall,
            "collectives": mesh.stats, "launches": launches,
            "single_device_ms": median_ms(lambda: mxu_ntt.lde_mxu(*plans, trace), 3)}


def phase_mesh(want_sha: str, want_poseidon_sha: str, r1cs, witness) -> dict:
    """d = 2 and 4 ranks, each an OS process on the one card, over gloo
    staged through pinned host memory (NCCL needs a card a rank); NCCL at
    d = 2 where the host has two cards. Every rank's proofs must equal phase
    5's (`real_size_poseidon`'s under Poseidon), every kernel of
    `mesh_kernels()` must launch in every rank's cold prove, and rank 0's
    proof must pass the single-device verifier. At d = 2 the ranks also
    prove on the CRT engine, at d = 2 and 4 they run `mesh_lde_case`
    (`mesh_rank`); the CRT kernels must launch in every rank there too."""
    from stark_tpu_torch.parallel import distributed
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    cards = torch.cuda.device_count()
    out = {"cards": cards,
           "why_gloo": "NCCL needs a card a rank; ranks that share one card take gloo, "
                       "each collective staged through pinned host buffers",
           "walls_measure": "host-staged gloo among ranks on one card, not multi-card scaling"}
    # (label, d, backend, routes, crt proves, the lde_mxu_sharded case)
    runs = [(f"gloo d={d}", d, "gloo", (("lagrange", "blake2s"), ("dft", "poseidon"))
             if d == 2 else (), d == 2, True) for d in MESH_SIZES]
    if cards >= 2:
        runs.append(("nccl d=2", 2, "nccl", (), False, False))
    else:
        out["nccl"] = f"not run: {cards} card"
    for label, d, backend, routes, crt, lde_case in runs:
        torch.cuda.empty_cache()
        t0 = time.time()
        ranks = distributed.run_ranks(mesh_rank, d, device="cuda", backend=backend,
                                      timeout=MESH_TIMEOUT_S,
                                      args=(REAL_CONSTRAINTS, routes, crt, lde_case))
        for rank in ranks:
            for key, rec in rank.items():
                if isinstance(rec, dict) and "proof_sha256" in rec:
                    want = want_poseidon_sha if "poseidon" in key else want_sha
                    if rec["proof_sha256"] != want:
                        raise AssertionError(f"{label} rank {rank['rank']} {key}: the proof "
                                             "differs from the single-device one")
            missing = [n for n in mesh_kernels() if rank["cold"]["launches"][n] <= 0]
            if crt:
                missing += [f"crt: {n}" for n in CRT_ONLY
                            if rank["crt cold"]["launches"][n] <= 0]
            if lde_case:
                case = rank["lde_mxu_sharded"]
                if not case["equal"]:
                    raise AssertionError(f"{label} rank {rank['rank']}: lde_mxu_sharded != "
                                         "the single-device lde_mxu")
                missing += [f"lde_mxu_sharded: {n}" for n, k in case["launches"].items()
                            if k <= 0]
            if missing:
                raise AssertionError(f"{label} rank {rank['rank']}: not launched: {missing}")
        proof = proof_mod.from_json(ranks[0].pop("proof"))
        if not runner.verify_with_witness(r1cs, witness[:2], proof, device="cuda",
                                          verify_cache=False):
            raise AssertionError(f"{label}: the verifier rejected rank 0's proof")
        out[label] = {"seconds": time.time() - t0, "ranks": ranks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase record to DIR/chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm prove and time its stages")
    args = ap.parse_args(argv)

    t0 = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.protocol.params import derive_params
    from stark_tpu_torch.ops import build, plan_cache

    # the CRT engine's tables are built once in this run and loaded from here after
    plan_cache.CACHE_DIR = PLAN_CACHE
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    def nvidia_smi(query: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    smi = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "clocks_max_sm_mhz": sm_mhz,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.time() - t0})

    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "library": os.path.relpath(so, ROOT), "ptxas": ptxas,
          "seconds": time.time() - t0})

    # a squaring chain fills one slot of each of the 3 regions per constraint
    params = derive_params(spec, 3 * REAL_CONSTRAINTS)
    t0 = time.time()
    kstats = phase_kernels(spec, device, params.steps, params.precision,
                           params.original_steps, sm_mhz * 1e6)
    crt_stats, crt_tables_s = phase_crt_kernels(spec, device, params.steps, params.precision)
    for result in crt_stats.values():
        add_bounds(result, sm_mhz * 1e6)
    kstats.update(crt_stats)
    # after each kernel's own cases: the first case stays the one its
    # `kernels` line entry reports
    for name, result in big_domain_cases(spec, device, sm_mhz * 1e6).items():
        kstats[name]["cases"].update(result["cases"])
        kstats[name]["max_abs_err"] = max(kstats[name]["max_abs_err"], result["max_abs_err"])
    emit({"phase": "kernels", "steps": params.steps, "precision": params.precision,
          "tolerance": "exact (torch.equal)", "results": kstats,
          "crt_tables_build_s": crt_tables_s, "seconds": time.time() - t0})

    t0 = time.time()
    prefix = phase_prefix(spec, device, params.steps, params.precision)
    emit({"phase": "prefix_prod", "steps": params.steps, "precision": params.precision,
          "tolerance": "exact (torch.equal with the CPU's values)", "results": prefix,
          "seconds": time.time() - t0})

    t0 = time.time()
    goldens = phase_goldens(device)
    emit({"phase": "goldens", "results": goldens, "seconds": time.time() - t0})
    bits = next(rec for rec in goldens if "launches" in rec)

    from stark_tpu_torch.r1cs.synth import squaring_chain

    r1cs, witness = squaring_chain(REAL_CONSTRAINTS)
    t0 = time.time()
    real, proof = phase_real(device, r1cs, witness, args.profile)
    emit({"phase": "real_size", "steps": params.steps, "precision": params.precision,
          **real, "seconds": time.time() - t0})

    t0 = time.time()
    file_route = phase_file_route(device, r1cs, witness, proof)
    emit({"phase": "file_route", "steps": params.steps, "precision": params.precision,
          **file_route, "seconds": time.time() - t0})

    t0 = time.time()
    traced = phase_tracing(device, r1cs, witness, proof)
    emit({"phase": "tracing", "steps": params.steps, "precision": params.precision,
          **traced, "seconds": time.time() - t0})

    # a circuit object of its own, so that its cold prove is the circuit's
    # first (Zb2^-1, which `vanishing_eval` makes, is kept on the circuit)
    t0 = time.time()
    pos_real, pos_proof = phase_real(device, *squaring_chain(REAL_CONSTRAINTS), args.profile,
                                     digest="poseidon")
    emit({"phase": "real_size_poseidon", "steps": params.steps, "precision": params.precision,
          **pos_real, "seconds": time.time() - t0})

    t0 = time.time()
    served = phase_serve(device, r1cs, witness, proof, pos_proof)
    emit({"phase": "serve", "steps": params.steps, "precision": params.precision,
          **served, "seconds": time.time() - t0})

    t0 = time.time()
    crt_run, _ = phase_real(device, r1cs, witness, args.profile, lde_engine="crt",
                            want_proof=proof)
    crt_run["worker"] = worker_on_crt(device, r1cs, witness, proof)
    crt_run["lde_many"] = phase_lde_engines(spec, device, params)
    emit({"phase": "crt", "steps": params.steps, "precision": params.precision,
          **crt_run, "seconds": time.time() - t0})

    t0 = time.time()
    shoup = phase_shoup_lde(spec, device, params)
    emit({"phase": "shoup_lde", "steps": params.steps, "precision": params.precision,
          **shoup, "seconds": time.time() - t0})

    t0 = time.time()
    big = phase_big_domain(device)
    emit({"phase": "big_domain", **big, "seconds": time.time() - t0})

    t0 = time.time()
    mesh = phase_mesh(real["proof_sha256"], pos_real["proof_sha256"], r1cs, witness)
    emit({"phase": "mesh", "steps": params.steps, "precision": params.precision, **mesh,
          "seconds": time.time() - t0})

    def line_entry(name):
        src, rep = KERNELS[name]
        label, case = next(iter(kstats[name]["cases"].items()))
        path, run = (("serve", served) if name in LAGRANGE_ONLY
                     else ("crt", crt_run) if name in CRT_ONLY
                     else ("goldens: bits", bits) if name in BITS_ONLY
                     else ("real_size_poseidon", pos_real) if name in POSEIDON_ONLY
                     else ("shoup_lde", shoup) if name in SHOUP_ONLY
                     else ("real_size", real))
        launches_mesh = {str(d): [rank["cold"]["launches"][name]
                                  for rank in mesh[f"gloo d={d}"]["ranks"]]
                         for d in MESH_SIZES}
        launches_mesh["2, crt"] = [rank["crt cold"]["launches"][name]
                                   for rank in mesh["gloo d=2"]["ranks"]]
        return {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "path": path, "launches": run["launches"][name],
                "launches_big_domain": big["cold"]["launches"][name],
                "launches_mesh": launches_mesh,
                "max_abs_err": kstats[name]["max_abs_err"], "case": label,
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "chain_ms": case["chain_ms"], "library_ms": case["library_ms"]}

    kernels = [line_entry(name) for name in KERNELS if name not in OFF_PATH]
    off_path = [line_entry(name) for name in OFF_PATH]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"records": RECORDS, "kernels": kernels, "off_path": off_path},
                      f, indent=1)
    print(json.dumps({"kernels": kernels, "off_path": off_path}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
