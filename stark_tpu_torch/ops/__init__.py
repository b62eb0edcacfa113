"""Field, NTT and hash layers: each CUDA kernel beside its plain version."""
