"""Losses and checkpoints for fitting: `ssim` (the 3DGS training loss and the
host-side quality scoreboard) and `snapshot` (splat sets and training-state
pytrees in .npz)."""
