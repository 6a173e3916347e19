"""The plain reference of the vision-language family: the dense decoder's,
whose ``nanoedge`` puts the image stub's patches ahead of the text."""
from fedbench.reference.dense import *  # noqa: F401,F403
