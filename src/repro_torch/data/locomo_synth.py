"""Synthetic LoCoMo-like benchmark (Maharana et al. 2024 analogue).

The real LoCoMo dataset + GPT-4.1-mini judge are unavailable offline, so this
module generates multi-session two-speaker conversations with *planted facts*
and questions in the paper's four reasoning categories (single-hop,
multi-hop, temporal, open-domain), sized so a full conversation ≈ 26k tokens
(the paper's Table 2 full-context figure).

Evaluation uses a deterministic ORACLE READER: it answers correctly iff the
supporting facts are surfaced in the retrieved context (the paper: accuracy
"serves as a direct reflection of how well the Advanced Augmentation pipeline
structured, preserved, and surfaced the relevant facts") — plus a documented
context-rot model (Hong et al. 2025): the probability of a reader slip grows
with injected-context size, which is what makes the full-context ceiling an
imperfect 100% in the paper.  All randomness is hash-derived → exactly
reproducible.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

from repro_torch.common.utils import stable_hash
from repro_torch.core.extraction import Message

DAY = 86400.0
BASE_TS = 1672531200.0          # 2023-01-01

NAMES = ["Caroline", "Melanie", "Gordon", "Adam", "Luiz", "Joanna", "Nate",
         "Audrey", "Marcus", "Priya", "Tomas", "Elena"]

FOODS = ["sushi", "lasagna", "pad thai", "falafel", "ramen", "tacos",
         "paella", "pierogi", "biryani", "gumbo"]
COLORS = ["teal", "crimson", "ochre", "indigo", "sage green", "burgundy"]
HOBBIES = ["rock climbing", "watercolor painting", "birdwatching", "chess",
           "pottery", "salsa dancing", "archery", "kayaking", "origami",
           "stargazing", "fencing", "baking sourdough"]
JOBS = ["teacher", "nurse", "architect", "data analyst", "chef",
        "electrician", "librarian", "paramedic", "translator", "botanist"]
CITIES = ["Lisbon", "Osaka", "Tallinn", "Valparaiso", "Galway", "Tbilisi",
          "Ljubljana", "Cusco", "Windhoek", "Da Nang"]
PETS = ["puppy", "kitten", "parrot", "hedgehog", "gecko", "rabbit"]
PET_NAMES = ["Max", "Luna", "Mochi", "Biscuit", "Nimbus", "Pepper"]
ITEMS = ["telescope", "espresso machine", "mountain bike", "record player",
         "sewing machine", "drone", "typewriter", "kayak"]
PLACES = ["Iceland", "Morocco", "Patagonia", "Kyoto", "the Azores",
          "Yellowstone", "Sicily", "Jordan"]
SKILLS = ["Portuguese", "the cello", "woodworking", "beekeeping",
          "sign language", "calligraphy"]

# vocab for the opt-in graph-chain categories (generate_conversation(...,
# graph_chains=True)) — deliberately disjoint from FOODS/PLACES/CITIES/
# HOBBIES/SKILLS so a chain answer can never be reached by lexical overlap
# with the question's own words
ALLERGENS = ["peanuts", "strawberries", "shellfish", "gluten", "dairy",
             "kiwi"]
TRIPS = ["Banff", "Cappadocia", "Big Sur", "Mount Fuji", "Svalbard",
         "Zanzibar", "Bariloche", "Hokkaido"]
ACTIVITIES = ["aikido", "glassblowing", "bouldering", "ceramics", "parkour",
              "tango"]

NOISE = [
    "How have you been lately?",
    "The weather here has been so strange this week.",
    "Did you watch anything good recently?",
    "Work has been keeping me pretty busy.",
    "I can't believe how fast this year is going.",
    "We should catch up more often, honestly.",
    "My commute was a nightmare this morning.",
    "I finally cleaned out the garage this weekend.",
    "Have you talked to the others recently?",
    "I've been sleeping terribly, probably too much coffee.",
    "That reminds me of something funny that happened.",
    "Anyway, enough about that.",
    "The neighbors are renovating again, the noise is constant.",
    "I tried that new cafe downtown, it was alright.",
    "My phone battery dies so fast these days.",
    "I keep meaning to go to the gym and never do.",
    "The traffic around the stadium was unbelievable.",
    "I reorganized my bookshelf by color, very satisfying.",
]

MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]


@dataclasses.dataclass
class Question:
    qid: str
    category: str                 # single_hop | multi_hop | temporal | open_domain
    question: str
    answer: str
    # each support is a list of strings that must co-occur on one context line
    supports: List[List[str]]
    min_supports: int = -1        # -1 => all required


@dataclasses.dataclass
class Conversation:
    conversation_id: str
    speakers: Tuple[str, str]
    sessions: List[Tuple[str, List[Message]]]      # (session_id, messages)
    questions: List[Question]

    def all_messages(self) -> List[Message]:
        return [m for _, msgs in self.sessions for m in msgs]


def _month_year(ts: float) -> str:
    import time as _t
    tm = _t.gmtime(ts)
    return f"{MONTHS[tm.tm_mon - 1]} {tm.tm_year}"


def _ym(ts: float) -> str:
    import time as _t
    tm = _t.gmtime(ts)
    return f"{tm.tm_year}-{tm.tm_mon:02d}"


def generate_conversation(seed: int = 0, n_sessions: int = 12,
                          noise_turns: int = 165,
                          name_pair=None,
                          graph_chains: bool = False) -> Conversation:
    """Defaults are sized so a full conversation ≈ 26k tokens — the paper's
    Table-2 full-context figure (26,031 tokens).  `name_pair` pins the two
    speakers (multi-conversation stores need disjoint speaker names).

    `graph_chains=True` additionally plants facts whose questions are
    answerable only through the memory graph (GRAPH_CATEGORIES:
    `multi_hop_graph` ≥2-hop entity chains, `temporal_graph` succession
    within a session) — the graph-stage scoreboard (benchmarks/
    graph_bench.py).  Off by default, and the disabled path consumes zero
    extra randomness, so default conversations are byte-identical to
    pre-graph ones."""
    rng = random.Random(seed)
    a, b = name_pair if name_pair else rng.sample(NAMES, 2)
    conv_id = f"conv{seed}"

    # --- plan facts ---------------------------------------------------------
    facts: Dict[str, Dict[str, object]] = {}
    for sp in (a, b):
        facts[sp] = {
            "food": rng.choice(FOODS),
            "color": rng.choice(COLORS),
            "hobbies": rng.sample(HOBBIES, 3),
            "job0": rng.choice(JOBS),
            "city": rng.choice(CITIES),
            "pet": rng.choice(PETS),
            "pet_name": rng.choice(PET_NAMES),
            "item": rng.choice(ITEMS),
            "place": rng.choice(PLACES),
            "skill": rng.choice(SKILLS),
        }
    # make the two speakers' jobs distinct so multi-hop identification works
    facts[b]["job0"] = rng.choice([j for j in JOBS if j != facts[a]["job0"]])
    job1 = {sp: rng.choice([j for j in JOBS
                            if j not in (facts[a]["job0"], facts[b]["job0"])])
            for sp in (a, b)}

    # --- schedule fact reveals over sessions --------------------------------
    reveals: Dict[int, List[Tuple[str, str]]] = {i: [] for i in range(n_sessions)}

    def put(sess, sp, text):
        reveals[sess].append((sp, text))

    sess_of: Dict[str, int] = {}
    for sp in (a, b):
        f = facts[sp]
        order = list(range(n_sessions))
        rng.shuffle(order)
        # cycle if there are more facts than sessions (small smoke configs)
        it = iter(order * 8)
        def nxt(tag):
            s = next(it)
            sess_of[f"{sp}:{tag}"] = s
            return s
        put(nxt("food"), sp, f"My favorite food is {f['food']}.")
        put(nxt("color"), sp, f"My favorite color is {f['color']}.")
        for i, h in enumerate(f["hobbies"]):
            put(nxt(f"hobby{i}"), sp, rng.choice(
                [f"I really love {h}.", f"I like {h}."]))
        put(nxt("job0"), sp, f"I work as a {f['job0']}.")
        put(nxt("city"), sp, f"I live in {f['city']}.")
        put(nxt("pet"), sp, f"I adopted a {f['pet']} named {f['pet_name']}.")
        put(nxt("item"), sp, f"I bought a {f['item']} last week.")
        put(nxt("place"), sp, f"I went to {f['place']}.")
        put(nxt("skill"), sp, f"I am learning {f['skill']}.")
        # temporal change: job switch in a later session than job0
        s_change = sess_of[f"{sp}:job0"]
        later = [s for s in range(n_sessions) if s > s_change]
        s_new = rng.choice(later) if later else n_sessions - 1
        sess_of[f"{sp}:job1"] = s_new
        put(s_new, sp,
            f"I used to work as a {f['job0']}, but now I am a {job1[sp]}.")

    # --- graph-chain facts (opt-in) -----------------------------------------
    # chain A (entity, 2-hop): pet -> pet_name -> allergen; the question
    # names the pet species, never the pet's name or the allergen.
    # chain B (causal, version chain): job0 -> job1 via the "works as"
    # supersession; the question names only the former job.
    # chain C (temporal, succession): trip -> activity planted as ONE
    # message (two clauses), so extraction order — and the temporal edge —
    # survives the turn shuffle; the question names only the trip.
    chains: List[Tuple[str, str, str, str]] = []
    if graph_chains:
        al2 = rng.sample(ALLERGENS, 2)
        trip2 = rng.sample(TRIPS, 2)
        act2 = rng.sample(ACTIVITIES, 2)
        for sp, al, trip, act in zip((a, b), al2, trip2, act2):
            chains.append((sp, al, trip, act))
            put(rng.randrange(n_sessions), sp,
                f"{facts[sp]['pet_name']} is allergic to {al}.")
            put(rng.randrange(n_sessions), sp,
                f"I went to {trip}. I started {act} classes.")

    # --- build sessions -------------------------------------------------------
    sessions: List[Tuple[str, List[Message]]] = []
    for s in range(n_sessions):
        ts = BASE_TS + s * 7 * DAY
        msgs: List[Message] = []
        turns: List[Tuple[str, str]] = []
        for sp, text in reveals[s]:
            turns.append((sp, text))
        for _ in range(noise_turns):
            turns.append((rng.choice((a, b)), rng.choice(NOISE)))
        rng.shuffle(turns)
        # prepend greetings for realism
        turns = [(a, f"Hey {b}!"), (b, f"Hi {a}, good to hear from you.")] + turns
        msgs = [Message(sp, tx, ts) for sp, tx in turns]
        sessions.append((f"s{s}", msgs))

    # --- questions -------------------------------------------------------------
    qs: List[Question] = []
    qn = 0

    def add(category, question, answer, supports, min_supports=-1):
        nonlocal qn
        qs.append(Question(f"{conv_id}-q{qn}", category, question, answer,
                           supports, min_supports))
        qn += 1

    # Question phrasing mixes exact wording (favors lexical/BM25 retrieval)
    # with paraphrases (favor the semantic/dense path) — the complementarity
    # the paper's hybrid search exploits.  `rng` choices keep it reproducible.
    for sp in (a, b):
        f = facts[sp]
        # single-hop (the dominant category, as in LoCoMo Table 3)
        add("single_hop", rng.choice([
            f"What is {sp}'s favorite food?",
            f"Which dish does {sp} enjoy the most?"]), f["food"],
            [[sp, f["food"]]])
        add("single_hop", rng.choice([
            f"What is {sp}'s favorite color?",
            f"Which shade is {sp} most into?"]), f["color"],
            [[sp, f["color"]]])
        add("single_hop", rng.choice([
            f"Which city does {sp} live in?",
            f"Which town is {sp} based in?"]), f["city"],
            [[sp, f["city"]]])
        add("single_hop", rng.choice([
            f"What pet did {sp} adopt?",
            f"What animal does {sp} have as a companion?"]), f["pet"],
            [[sp, f["pet"]]])
        add("single_hop", rng.choice([
            f"What did {sp} buy recently?",
            f"What did {sp} purchase the other week?"]), f["item"],
            [[sp, f["item"]]])
        add("single_hop", rng.choice([
            f"What is {sp} learning?",
            f"What new skill is {sp} studying?"]), f["skill"],
            [[sp, f["skill"]]])
        add("single_hop", rng.choice([
            f"Where did {sp} travel to?",
            f"Where did {sp} go on a trip?"]), f["place"],
            [[sp, f["place"]]])
        add("single_hop", rng.choice([
            f"What does {sp} work as now?",
            f"What does {sp} do for a living these days?"]), job1[sp],
            [[sp, job1[sp]]])
        # multi-hop
        add("multi_hop", f"What is the name of {sp}'s {f['pet']}?",
            f["pet_name"],
            [[sp, f["pet"]], [f["pet"], f["pet_name"]]])
        add("multi_hop",
            f"Which city does the person who first worked as a {f['job0']} live in?",
            f["city"], [[sp, f["job0"]], [sp, f["city"]]])
        add("multi_hop",
            f"What food does the person learning {f['skill']} like most?",
            f["food"], [[sp, f["skill"]], [sp, f["food"]]])
        # temporal
        ts_place = BASE_TS + sess_of[f"{sp}:place"] * 7 * DAY
        add("temporal", rng.choice([
            f"When did {sp} travel to {f['place']}?",
            f"In which month was {sp}'s trip to {f['place']}?"]),
            _month_year(ts_place), [[f["place"], _ym(ts_place)]])
        add("temporal",
            f"What did {sp} work as before becoming a {job1[sp]}?",
            f["job0"], [[sp, f["job0"]]])
        ts_item = BASE_TS + sess_of[f"{sp}:item"] * 7 * DAY
        add("temporal", f"In which month did {sp} buy the {f['item']}?",
            _month_year(ts_item), [[f["item"], _ym(ts_item)]])
        # open-domain
        add("open_domain", rng.choice([
            f"What hobbies does {sp} enjoy?",
            f"What pastimes is {sp} interested in?"]),
            ", ".join(f["hobbies"]),
            [[sp, h] for h in f["hobbies"]], min_supports=2)

    # graph-chain questions: supports name only the chain's FAR end (the
    # triple the flat retriever has no lexical/semantic bridge to)
    for sp, al, trip, act in chains:
        f = facts[sp]
        add("multi_hop_graph",
            f"What food can {sp}'s {f['pet']} never eat?", al,
            [[f["pet_name"], al]])
        add("multi_hop_graph",
            f"What is the former {f['job0']}'s current profession?",
            job1[sp], [[sp, job1[sp]]])
        add("temporal_graph",
            f"Which class did {sp} start right after the trip to {trip}?",
            act, [[sp, act]])

    return Conversation(conv_id, (a, b), sessions, qs)


# ---------------------------------------------------------------------------
# Oracle reader + judge
# ---------------------------------------------------------------------------

def _support_found(context_lower_lines: List[str], support: List[str]) -> bool:
    needles = [s.lower() for s in support]
    return any(all(n in line for n in needles) for line in context_lower_lines)


def context_rot_p(tokens: int, coef: float = 0.035) -> float:
    """Documented reader-slip model (context rot, Hong et al. 2025): failure
    probability grows with injected tokens; ~0 below 1k, ~13% at 26k."""
    import math
    return min(0.30, coef * math.log2(1.0 + tokens / 1000.0))


def oracle_read(question: Question, context_text: str, *,
                rot_coef: float = 0.035, salt: str = "") -> str:
    """Deterministic reader: answers the gold answer iff the supports are in
    the context and the context-rot coin doesn't fire."""
    lines = [ln.lower() for ln in context_text.splitlines() if ln.strip()]
    found = [s for s in question.supports if _support_found(lines, s)]
    need = len(question.supports) if question.min_supports < 0 else question.min_supports
    if len(found) < need:
        return "I don't know"
    p = context_rot_p(len(context_text.split()), rot_coef)
    coin = stable_hash(question.qid + salt, 10_000) / 10_000.0
    if coin < p:
        return "I don't remember exactly"
    if question.category == "open_domain":
        hobbies = [s[-1] for s in found]
        return ", ".join(hobbies)
    return question.answer


def judge(question: Question, answer: str) -> bool:
    """Generous containment judge (paper Appendix B analogue)."""
    al = answer.lower()
    if question.category == "open_domain":
        gold_items = [g.strip().lower() for g in question.answer.split(",")]
        hits = sum(1 for g in gold_items if g in al)
        return hits * 2 >= len(gold_items)
    return question.answer.lower() in al


CATEGORIES = ("single_hop", "multi_hop", "temporal", "open_domain")

# the opt-in categories graph_chains=True adds (kept out of CATEGORIES:
# default conversations, and every consumer weighting by LOCOMO_WEIGHTS,
# never see them)
GRAPH_CATEGORIES = ("multi_hop_graph", "temporal_graph")

# LoCoMo question-count weights (paper Table 3, adversarial excluded)
LOCOMO_WEIGHTS = {"multi_hop": 282, "temporal": 321, "open_domain": 96,
                  "single_hop": 830}
