"""The plain reference that decides `correct`, and the replay that counts
the rasterizer's work for the rooflines.

Plain PyTorch, float32, TF32 off (as the configurations state), with no
kernel. It imports nothing of the program and takes nothing the program
made: its inputs come from `gsbench/scene.py` and the configuration. It is
a frozen copy of the port's plain versions (projection, tile binning, the
tile rasterizer's forward and backward, the losses, Adam and the LR
schedule), so that an edit of the port cannot move its own yardstick.

  render.py  projection → binning → plain rasterizer, forward and backward
  train.py   the 3DGS / LGDWT-GS losses, Adam and the learning rates, and
             the reference's steps from a seed-made state
"""
