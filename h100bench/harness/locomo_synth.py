"""The benchmark's conversation generator: a frozen copy of the synthetic
LoCoMo-like generator of `repro_torch/data/locomo_synth.py` (Maharana et
al. 2024, arXiv:2402.17753, analogue), `generate_conversation` only.

The benchmark makes every stored conversation and every question from its
own copy, so a change to the program's generator cannot change what is
measured.  `Message` is a local copy of the program's message record (the
same three fields); the program reads it by attribute.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Tuple



@dataclasses.dataclass(frozen=True)
class Message:
    speaker: str
    text: str
    timestamp: float = 0.0

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
