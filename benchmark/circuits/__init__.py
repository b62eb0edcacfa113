"""Circuit families, one module a family: `write_r1cs(path, sizes)` writes
the circuit's `.r1cs` and `witness(sizes, rng)` makes one witness as
(n_wires, 32) uint8 little-endian rows. A configuration names its family
under `circuit.family`."""
