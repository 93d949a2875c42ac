"""The paper's §3 applications over the port's MapReduce API (per-op mode)."""
from repro_torch.core.algorithms.gmm import GMMResult, gmm_em, gmm_em_reference
from repro_torch.core.algorithms.kmeans import KMeansResult, kmeans
from repro_torch.core.algorithms.knn import KNNResult, knn, knn_full_sort
from repro_torch.core.algorithms.pagerank import PageRankResult, pagerank
from repro_torch.core.algorithms.pi import estimate_pi, estimate_pi_handrolled
from repro_torch.core.algorithms.wordcount import counts_dict, wordcount

__all__ = [
    "GMMResult",
    "KMeansResult",
    "KNNResult",
    "PageRankResult",
    "counts_dict",
    "estimate_pi",
    "estimate_pi_handrolled",
    "gmm_em",
    "gmm_em_reference",
    "kmeans",
    "knn",
    "knn_full_sort",
    "pagerank",
    "wordcount",
]
