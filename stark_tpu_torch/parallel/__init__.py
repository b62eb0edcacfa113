"""Multi-device proving on torch.distributed: the 1-D mesh, the four-step
NTT, the sharded columns and Merkle trees."""
