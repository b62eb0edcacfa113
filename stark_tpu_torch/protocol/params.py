"""Protocol constants and domain-parameter derivation.

Constants from `r1cs-stark/src/utils.rs:134-136` and the step/precision
derivation from `prove.rs:30-94` / `verify.rs:25-67` (both sides must derive
identical domains for Fiat-Shamir to line up).
"""

from __future__ import annotations

from dataclasses import dataclass

from stark_tpu_torch.fields.field import FieldSpec

LOG_EXTENSION_FACTOR = 3
EXTENSION_FACTOR = 8
SPOT_CHECK_SECURITY_FACTOR = 80


def log2_ceil(value: int) -> int:
    """The r1cs-stark variant (`utils.rs:14-23`): log2_ceil(1)=1, and exact
    powers of two round UP one extra (log2_ceil(8)=4) -- the prover passes
    original_steps-1 so the net effect is next-pow2 with a minimum."""
    log_value = 1
    tmp = value
    while tmp > 1:
        tmp //= 2
        log_value += 1
    return log_value


@dataclass(frozen=True)
class DomainParams:
    original_steps: int
    steps: int
    precision: int
    skips: int
    g1: int
    g2: int

    @property
    def log_steps(self) -> int:
        return self.steps.bit_length() - 1

    @property
    def log_precision(self) -> int:
        return self.precision.bit_length() - 1


def derive_params(spec: FieldSpec, original_steps: int) -> DomainParams:
    assert original_steps % 3 == 0
    log_steps = log2_ceil(original_steps - 1)
    steps = max(8, 2**log_steps)
    precision = steps * EXTENSION_FACTOR
    assert precision <= 2**spec.two_adicity, "trace exceeds field 2-adicity"
    g2 = spec.root_of_unity(precision)  # generator^((p-1)/precision)
    skips = EXTENSION_FACTOR
    g1 = pow(g2, skips, spec.p)
    return DomainParams(
        original_steps=original_steps,
        steps=steps,
        precision=precision,
        skips=skips,
        g1=g1,
        g2=g2,
    )
