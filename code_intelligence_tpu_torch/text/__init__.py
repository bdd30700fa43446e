from code_intelligence_tpu_torch.text.rules import (
    SPECIALS,
    TK_UNK,
    build_issue_text,
)
from code_intelligence_tpu_torch.text.tokenizer import Tokenizer
from code_intelligence_tpu_torch.text.vocab import Vocab

__all__ = ["SPECIALS", "TK_UNK", "Tokenizer", "Vocab", "build_issue_text"]
