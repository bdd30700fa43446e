from code_intelligence_tpu_torch.data.corpus import (
    CorpusWriter,
    ShardedTokenView,
    TokenCorpus,
    build_corpus,
)
from code_intelligence_tpu_torch.data.lm_loader import LMStreamLoader

__all__ = [
    "CorpusWriter",
    "ShardedTokenView",
    "TokenCorpus",
    "build_corpus",
    "LMStreamLoader",
]
