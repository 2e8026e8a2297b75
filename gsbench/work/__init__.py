"""The yardstick: the card's published peaks and the work that the inputs
ask of each kernel and of a whole step, counted by the benchmark's own
functions from the inputs (shapes, and the reference's replay of the
blend), never from the program's outputs or counters.

  peaks.py   H100 SXM peaks: f32 outside the tensor cores, HBM bandwidth
  raster.py  the tile rasterizer's operations and bytes, and the bound
  step.py    f32 operations of a training step and of an inference frame
"""
