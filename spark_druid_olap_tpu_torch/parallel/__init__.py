"""Multi-device execution on one host: `mesh` (meshes of devices and the
merge), `distributed` (the mesh engine) and `spmd_arena` (its per-device
CUDA graphs over a stacked block layout)."""
