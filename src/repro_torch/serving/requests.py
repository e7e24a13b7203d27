"""Serving request/response types."""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Response:
    request_id: int
    tokens: List[int]
    prompt_len: int
    finished: bool = True
