from repro_torch.data.batches import make_batch, make_decode_inputs
from repro_torch.data.synthetic import LinearProblem, make_linear_problem

__all__ = ["LinearProblem", "make_linear_problem", "make_batch", "make_decode_inputs"]
