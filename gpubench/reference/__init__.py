"""The benchmark's plain reference: plain PyTorch, independent of the program.

The modules beside `frame.py` and `fit.py` are frozen copies of the port's
plain modules (`_torch_util`, `camera`, `config`, `sdf/`, `points/`,
`render/{projector,packing,binning,blend,sh,compositor}`, `utils/ssim`),
kept here so that a later change to the program cannot change what it is
held to.  Nothing here imports the program or JAX.
"""
