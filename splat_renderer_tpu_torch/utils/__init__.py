"""Host-side helpers: `ssim` (the 3DGS training loss and the host-side
quality scoreboard), `snapshot` (splat sets and training-state pytrees in
.npz), `ply` (3DGS `.ply` scenes) and `image` (PNG files and uint8
quantization)."""
