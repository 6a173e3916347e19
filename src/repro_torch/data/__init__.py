from repro_torch.data.partition import dirichlet_partition, partition_stats
from repro_torch.data.pipeline import examples_to_batches, make_federated_data
from repro_torch.data.synthetic import Example, SyntheticVQA
from repro_torch.data.tokenizer import ToyTokenizer

__all__ = [
    "dirichlet_partition",
    "partition_stats",
    "examples_to_batches",
    "make_federated_data",
    "Example",
    "SyntheticVQA",
    "ToyTokenizer",
]
