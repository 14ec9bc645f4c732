"""Multi-process rendering: image rows sharded over the ranks of a
torch.distributed process group, gradients all-reduced (mesh.py)."""
