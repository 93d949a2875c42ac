"""The paper's §3 applications over the port's MapReduce API (per-op mode).

GMM and kNN come with a later slice of the port.
"""
from repro_torch.core.algorithms.kmeans import KMeansResult, kmeans
from repro_torch.core.algorithms.pagerank import PageRankResult, pagerank
from repro_torch.core.algorithms.pi import estimate_pi, estimate_pi_handrolled
from repro_torch.core.algorithms.wordcount import counts_dict, wordcount

__all__ = [
    "KMeansResult",
    "PageRankResult",
    "counts_dict",
    "estimate_pi",
    "estimate_pi_handrolled",
    "kmeans",
    "pagerank",
    "wordcount",
]
