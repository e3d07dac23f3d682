"""The paper's own experiment configurations (Section 4): least squares and
sparse recovery with a (40, 20) rate-1/2 LDPC code on w = 40 workers."""
import dataclasses

__all__ = ["PaperConfig", "FIG1_LS", "FIG2_SPARSE_OVER", "FIG3_SPARSE_UNDER"]


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    name: str
    m: int                 # samples
    k: int                 # model dimension
    w: int = 40            # workers
    ldpc_l: int = 3
    ldpc_r: int = 6        # rate 1/2 -> (2k, k) code with N matched to w via k=K
    stragglers: tuple = (5, 10)
    sparsity: tuple = ()   # nonzero-fraction grid (sparse recovery figures)
    steps: int = 800
    tol: float = 1e-2      # ||theta - theta*|| threshold for "converged"


FIG1_LS = PaperConfig(name="fig1_least_squares", m=2048, k=0,  # k swept
                      stragglers=(5, 10))
FIG2_SPARSE_OVER = PaperConfig(name="fig2_sparse_overdetermined", m=2048, k=0,
                               sparsity=(0.1, 0.2, 0.3, 0.4, 0.5))
FIG3_SPARSE_UNDER = PaperConfig(name="fig3_sparse_underdetermined", m=1024,
                                k=2000, sparsity=(0.05, 0.1))
