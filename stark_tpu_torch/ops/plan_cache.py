"""Where the CRT engine caches the host-built tables of its plans.

`ops/mxu_ntt.py make_ntt_plan_cached` writes and reads its `ntt_<hash>.npz`
files under `CACHE_DIR` (`~` expanded at each use), the one setting of the
cache: a deployment, a test or `chip_smoke.py` sets it before the first
plan. It lives in a module of its own, which imports nothing, so that `cli
cache-pack` and `cache-unpack` find the directory without importing torch.
"""

CACHE_DIR = "~/.cache/stark_tpu_torch_plans"
