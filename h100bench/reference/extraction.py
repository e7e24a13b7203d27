"""Plain reference of the memory layer's write path: the rule extraction of
semantic triples and session summaries, and their rendering.

A frozen copy of `repro_torch/core/extraction.py`'s `RuleExtractor`
(patterns, clause split, de-duplication, summary text) and of the render
formats of `core/triples.py` and `core/summaries.py`.  `Triple` and
`Summary` here are plain records; nothing imports the program.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Triple:
    subject: str
    predicate: str
    object: str
    conversation_id: str = ""
    session_id: str = ""
    timestamp: float = 0.0
    source_text: str = ""

    def text(self) -> str:
        return f"{self.subject} {self.predicate} {self.object}"

    def render(self) -> str:
        ts = (time.strftime("%Y-%m-%d", time.gmtime(self.timestamp))
              if self.timestamp else "?")
        return f"[{ts}] ({self.subject}; {self.predicate}; {self.object})"


@dataclasses.dataclass(frozen=True)
class Summary:
    conversation_id: str
    session_id: str
    timestamp: float
    text: str

    def render(self) -> str:
        ts = (time.strftime("%Y-%m-%d", time.gmtime(self.timestamp))
              if self.timestamp else "?")
        return f"[{ts}] (session {self.session_id}) {self.text}"


# (regex, subject_fn, predicate, object_group) — subject is the speaker
# unless the pattern binds its own.  Patterns are ordered; first match per
# clause wins.
_P = [
    (re.compile(r"\bmy favorite (\w+(?: \w+)?) is (?:the |a |an )?([\w' -]+)", re.I),
     "favorite {1}", 2),
    (re.compile(r"\bi (?:really )?(?:love|adore) ([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "loves", 1),
    (re.compile(r"\bi (?:really )?(?:like|enjoy) ([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "likes", 1),
    (re.compile(r"\bi prefer ([\w' -]+?)(?: over [\w' -]+)?(?:[.,!]|$| and )", re.I),
     "prefers", 1),
    (re.compile(r"\bi (?:work|works) as (?:a |an )?([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "works as", 1),
    (re.compile(r"\bi(?: now)? live in ([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "lives in", 1),
    (re.compile(r"\bi moved to ([\w' -]+?)(?: last [\w]+| in [\w ]+)?(?:[.,!]|$| and )", re.I),
     "lives in", 1),
    (re.compile(r"\bi adopted (?:a |an )?([\w' -]+?)(?: named ([\w' -]+))?(?:[.,!]|$| and )", re.I),
     "adopted", 1),
    (re.compile(r"\bi bought (?:a |an |some )?([\w' -]+?)(?: last [\w]+| yesterday| in [\w ]+)?(?:[.,!]|$| and )", re.I),
     "bought", 1),
    (re.compile(r"\bi (?:went|travell?ed) to ([\w' -]+?)(?: last [\w]+| in [\w ]+| yesterday)?(?:[.,!]|$| and )", re.I),
     "visited", 1),
    (re.compile(r"\bi(?:'m| am) (?:learning|studying) ([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "is learning", 1),
    (re.compile(r"\bi started (?:learning |studying )?([\w' -]+?)(?: classes| lessons)?(?: last [\w]+| in [\w ]+)?(?:[.,!]|$| and )", re.I),
     "started", 1),
    (re.compile(r"\bi(?:'m| am) allergic to ([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "is allergic to", 1),
    (re.compile(r"\bi(?:'m| am) (?:a |an )([\w' -]+?) by trade(?:[.,!]|$| and )", re.I),
     "works as", 1),
    (re.compile(r"\bmy ([\w]+)(?:'s name)? is (?:called )?([\w' -]+?)(?:[.,!]|$| and )", re.I),
     "{1} is", 2),
]

_USED_TO = re.compile(
    r"\bi used to (?:work as|be) (?:a |an )?([\w' -]+?),? but (?:now i(?:'m| am)|i became) (?:a |an )?([\w' -]+?)(?:[.,!]|$| and )",
    re.I)

# third-person allergy: "Muffin is allergic to peanuts" — the one pattern
# whose subject is the named entity, not the speaker (case-sensitive on the
# capitalized name so "he is allergic to ..." stays a non-match)
_THIRD_ALLERGIC = re.compile(
    r"\b([A-Z][\w'-]+) is allergic to ([\w' -]+?)(?:[.,!]|$| and )")

_NOISE_WORDS = {"it", "that", "this", "them", "those", "there"}


def _clean(s: str) -> str:
    return re.sub(r"\s+", " ", s).strip(" .,!?'").lower()


class RuleExtractor:
    """Deterministic cognitive filter: scans each message for concrete facts,
    preferences, constraints and evolving attributes (paper §2.1)."""

    def extract(self, conversation_id: str, session_id: str,
                messages: Sequence) -> Tuple[List[Triple], Summary]:
        triples: List[Triple] = []
        seen = set()
        last_ts = 0.0
        for msg in messages:
            last_ts = max(last_ts, msg.timestamp)
            for clause in re.split(r"(?<=[.!?])\s+", msg.text):
                m = _USED_TO.search(clause)
                if m:
                    for obj, pred in ((m.group(1), "used to work as"),
                                      (m.group(2), "works as")):
                        o = _clean(obj)
                        key = (msg.speaker, pred, o)
                        if o and o not in _NOISE_WORDS and key not in seen:
                            seen.add(key)
                            triples.append(Triple(
                                subject=msg.speaker, predicate=pred, object=o,
                                conversation_id=conversation_id,
                                session_id=session_id, timestamp=msg.timestamp,
                                source_text=clause.strip()))
                    continue
                m = _THIRD_ALLERGIC.search(clause)
                if m and m.group(1).lower() != "i":
                    subj = m.group(1)
                    obj = _clean(m.group(2))
                    key = (subj.lower(), "is allergic to", obj)
                    if obj and obj not in _NOISE_WORDS and key not in seen:
                        seen.add(key)
                        triples.append(Triple(
                            subject=subj, predicate="is allergic to",
                            object=obj, conversation_id=conversation_id,
                            session_id=session_id, timestamp=msg.timestamp,
                            source_text=clause.strip()))
                    continue
                for rx, pred_tpl, obj_g in _P:
                    m = rx.search(clause)
                    if not m:
                        continue
                    pred = pred_tpl.format(*([None] + [
                        _clean(g or "") for g in m.groups()]))
                    obj = _clean(m.group(obj_g) or "")
                    if not obj or obj in _NOISE_WORDS:
                        continue
                    key = (msg.speaker, pred, obj)
                    if key in seen:
                        continue
                    seen.add(key)
                    triples.append(Triple(
                        subject=msg.speaker, predicate=pred, object=obj,
                        conversation_id=conversation_id,
                        session_id=session_id, timestamp=msg.timestamp,
                        source_text=clause.strip()))
                    # secondary fact: "adopted a <pet> named <name>"
                    if pred == "adopted" and m.lastindex and m.lastindex >= 2 \
                            and m.group(2):
                        name = _clean(m.group(2))
                        if name and (obj, "is named", name) not in seen:
                            seen.add((obj, "is named", name))
                            triples.append(Triple(
                                subject=obj, predicate="is named", object=name,
                                conversation_id=conversation_id,
                                session_id=session_id, timestamp=msg.timestamp,
                                source_text=clause.strip()))
        summary = self._summarize(conversation_id, session_id, messages,
                                  triples, last_ts)
        return triples, summary

    @staticmethod
    def _summarize(conversation_id, session_id, messages, triples, ts) -> Summary:
        speakers = sorted({m.speaker for m in messages})
        topics = []
        for t in triples:
            frag = f"{t.subject} {t.predicate} {t.object}"
            if frag not in topics:
                topics.append(frag)
        head = " and ".join(speakers) if speakers else "the participants"
        body = "; ".join(topics[:12]) if topics else "small talk"
        text = (f"{head} caught up over {len(messages)} messages. "
                f"Key developments: {body}.")
        return Summary(conversation_id=conversation_id, session_id=session_id,
                       timestamp=ts, text=text)
