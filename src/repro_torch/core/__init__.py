# The Memori persistent memory layer: Advanced Augmentation (triples +
# summaries), hybrid retrieval over the device-resident vector index +
# hashed BM25, token budgeting, and the multi-tenant service.
from repro_torch.core.api import (RawRetrieval, RetrievalPlan,  # noqa: F401
                                  RetrieveRequest)
from repro_torch.core.augmentation import AdvancedAugmentation  # noqa: F401
from repro_torch.core.embedder import HashEmbedder, LMEmbedder  # noqa: F401
from repro_torch.core.extraction import (LMExtractor, Message,  # noqa: F401
                                         RuleExtractor)
from repro_torch.core.graph import MemoryGraph  # noqa: F401
from repro_torch.core.memory import (ANSWER_PROMPT, MemoriMemory,  # noqa: F401
                                     RetrievedContext)
from repro_torch.core.sdk import MemoriClient, MemoryLike  # noqa: F401
from repro_torch.core.service import MemoryService, NamespaceView  # noqa: F401
from repro_torch.core.store import (MemoryStore, StoreInvariantError,  # noqa: F401
                                    TenantState)
from repro_torch.core.summaries import Summary, SummaryStore  # noqa: F401
from repro_torch.core.triples import Triple, TripleStore  # noqa: F401
