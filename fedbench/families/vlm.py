"""The vision-language family: the dense decoder with the image stub's
patches through a linear connector ahead of the text (``families/dense.py``)."""
from fedbench.families.dense import *  # noqa: F401,F403
