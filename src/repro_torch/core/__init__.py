# The Memori persistent memory layer: Advanced Augmentation (triples +
# summaries), hybrid retrieval over the device-resident vector index +
# hashed BM25, token budgeting, the multi-tenant service, its request
# scheduler with admission control, shard-wise placement, and the SDK (in
# process and over HTTP).
from repro_torch.core.admission import (PRIORITY_HIGH,  # noqa: F401
                                        PRIORITY_LOW, PRIORITY_NORMAL,
                                        AdmissionController, AdmissionError,
                                        AdmissionPolicy, TenantPolicy,
                                        admission_policy_from_json,
                                        tenant_policy_from_json)
from repro_torch.core.api import (CompactRequest, EvictRequest,  # noqa: F401
                                  MemoryRequest, MemoryResponse, RawRetrieval,
                                  RecordRequest, RetrievalPlan,
                                  RetrieveRequest)
from repro_torch.core.augmentation import AdvancedAugmentation  # noqa: F401
from repro_torch.core.embedder import HashEmbedder, LMEmbedder  # noqa: F401
from repro_torch.core.extraction import (LMExtractor, Message,  # noqa: F401
                                         RuleExtractor)
from repro_torch.core.graph import MemoryGraph  # noqa: F401
from repro_torch.core.lifecycle import (BackpressureError,  # noqa: F401
                                        LifecyclePolicy, LifecycleRuntime)
from repro_torch.core.memory import (ANSWER_PROMPT, MemoriMemory,  # noqa: F401
                                     RetrievedContext)
from repro_torch.core.scheduler import MemoryScheduler  # noqa: F401
from repro_torch.core.sdk import (HttpMemory, MemoriClient,  # noqa: F401
                                  MemoryLike, RetryPolicy)
from repro_torch.core.service import MemoryService, NamespaceView  # noqa: F401
from repro_torch.core.shards import ShardedBank  # noqa: F401
from repro_torch.core.store import (MemoryStore, StoreInvariantError,  # noqa: F401
                                    TenantState)
from repro_torch.core.summaries import Summary, SummaryStore  # noqa: F401
from repro_torch.core.tiering import TierManager, TierPolicy  # noqa: F401
from repro_torch.core.triples import Triple, TripleStore  # noqa: F401
