"""repro_torch.core — flexible retrieval over dense, sparse and fused
sparse+dense representations (counterpart of ``repro.core``).

Layering (bottom to top):
  sparse / spaces          representations + distance-agnostic spaces
  brute_force              exact k-NN / MIPS
  backends                 pluggable execution paths (reference/streaming/
                           cuda exact; graph_ann/napp approximate)
  inverted_index           exact sparse MIPS via postings (Lucene's role)
  graph_ann / napp         approximate k-NN (NSW/HNSW, NAPP)
  scorers / model1         FlexNeuART feature extractors
  fusion                   LETOR (coordinate ascent, LambdaMART) + export
  pipeline                 multi-stage funnel (Fig. 1)
"""

from repro_torch.core.sparse import SparseVectors, from_dense, densify  # noqa: F401
from repro_torch.core.spaces import DenseSpace, SparseSpace, FusedSpace, FusedVectors  # noqa: F401
from repro_torch.core.brute_force import TopK, exact_topk, streaming_topk  # noqa: F401
from repro_torch.core.backends import (ExecutionBackend, ReferenceBackend,  # noqa: F401
                                       StreamingBackend, CudaBackend,
                                       GraphANNBackend, NappBackend,
                                       available_backends, make_backend,
                                       register_backend, resolve_backend)
from repro_torch.core.inverted_index import build_inverted_index, daat_topk  # noqa: F401
from repro_torch.core.graph_ann import GraphIndex, nn_descent, beam_search  # noqa: F401
from repro_torch.core.napp import NappIndex, build_napp, napp_search  # noqa: F401
from repro_torch.core.pipeline import RetrievalPipeline  # noqa: F401
