"""Multispectral RGB+NIR training CLI of the port (the role of the root
`train_nir.py`; reference `mult-dwtgs/train_nir.py:32-151`):

    python -m sparse_view_3dgs_pack_tpu_torch.train_nir -s <scene> -m <out>

the same as `python -m sparse_view_3dgs_pack_tpu_torch.train --method
mult-dwtgs`, with every flag of that CLI."""

import sys

from .train.__main__ import main

if __name__ == "__main__":
    main(["--method", "mult-dwtgs"] + sys.argv[1:])
