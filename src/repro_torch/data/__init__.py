from repro_torch.data.synthetic import LinearProblem, make_linear_problem

__all__ = ["LinearProblem", "make_linear_problem"]
