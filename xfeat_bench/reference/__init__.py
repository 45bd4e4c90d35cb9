"""The benchmark's plain reference: XFeat's sparse extraction, the
mutual-nearest-neighbour matcher and LighterGlue, written in plain PyTorch
from the published equations (XFeat, Potje et al., CVPR 2024, and its
repository's `modules/model.py` and `modules/xfeat.py`; LightGlue,
Lindenberger et al., ICCV 2023, as `modules/lighterglue.py` configures it).

It reads the committed `.npz` weights itself and folds BatchNorm itself.
It imports no module of the program under test. Every product (a
convolution, a linear layer, a matrix product) goes through `precision.py`,
which runs it in full float32 or, for the control, with its operands
rounded to TF32.
"""
