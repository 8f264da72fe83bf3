"""Name-entity tagging: a host-side heuristic tagger.

The port's copy of ``transmogrifai_tpu/utils/text_ner.py``, the stand-in
for the reference's OpenNLP statistical NER
(utils/.../text/NameEntityTagger.scala:71-86 NameEntityType,
core/.../utils/text/OpenNLPNameEntityTagger.scala): rule- and
gazetteer-based. Honorific-introduced capitalized spans tag Person,
corporate suffixes Organization, a compact country and city gazetteer
Location, and month, clock, currency and percent patterns
Date/Time/Money/Percentage. Deterministic, dependency-free, and a host
pass, as in the JAX package.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set, Tuple

__all__ = ["NameEntityType", "HeuristicNameEntityTagger",
           "split_sentences"]


class NameEntityType:
    """(reference NameEntityTagger.scala:71-86)"""
    Date = "Date"
    Location = "Location"
    Money = "Money"
    Organization = "Organization"
    Percentage = "Percentage"
    Person = "Person"
    Time = "Time"
    Misc = "Misc"
    Other = "Other"
    values = (Date, Location, Money, Organization, Percentage, Person,
              Time, Misc, Other)


_HONORIFICS = {"mr", "mr.", "mrs", "mrs.", "ms", "ms.", "dr", "dr.",
               "prof", "prof.", "sir", "madam", "president", "senator",
               "judge", "captain", "governor", "mayor", "chancellor",
               "minister", "ceo", "st", "st."}
_ORG_SUFFIXES = {"inc", "inc.", "corp", "corp.", "co", "co.", "ltd",
                 "ltd.", "llc", "plc", "gmbh", "ag", "sa", "nv", "oy",
                 "company", "corporation", "university", "institute",
                 "bank", "group", "holdings", "industries", "systems",
                 "technologies", "laboratories", "labs", "partners",
                 "foundation", "association", "agency", "ministry",
                 "department", "committee", "council"}
_LOCATIONS = {
    # countries / regions
    "usa", "u.s.", "u.s.a.", "uk", "u.k.", "france", "germany", "spain",
    "italy", "china", "japan", "india", "canada", "australia", "brazil",
    "mexico", "russia", "england", "scotland", "wales", "ireland",
    "america", "europe", "asia", "africa", "netherlands", "belgium",
    "switzerland", "austria", "sweden", "norway", "denmark", "finland",
    "poland", "portugal", "greece", "turkey", "egypt", "israel",
    "argentina", "chile", "colombia", "peru", "korea", "vietnam",
    "thailand", "indonesia", "malaysia", "singapore", "philippines",
    "nigeria", "kenya", "morocco", "ukraine",
    # cities
    "paris", "london", "tokyo", "berlin", "madrid", "rome", "moscow",
    "beijing", "shanghai", "sydney", "melbourne", "toronto", "vancouver",
    "montreal", "chicago", "boston", "seattle", "francisco", "york",
    "angeles", "dallas", "houston", "miami", "atlanta", "denver",
    "phoenix", "philadelphia", "amsterdam", "brussels", "vienna",
    "zurich", "geneva", "munich", "hamburg", "frankfurt", "barcelona",
    "lisbon", "dublin", "stockholm", "oslo", "copenhagen", "helsinki",
    "warsaw", "prague", "budapest", "athens", "istanbul", "cairo",
    "mumbai", "delhi", "bangalore", "seoul", "osaka", "taipei",
    "jakarta", "bangkok", "manila", "lagos", "nairobi",
    # US states
    "california", "texas", "washington", "florida", "oregon", "arizona",
    "nevada", "colorado", "georgia", "virginia", "ohio", "michigan",
    "illinois", "massachusetts", "pennsylvania", "carolina", "alaska",
    "hawaii", "utah", "montana", "idaho", "kansas", "iowa", "missouri",
}
#: common given names — the gazetteer backbone of the Person tag (the
#: OpenNLP maxent model's role; a name list + context cues is the
#: classic statistical-NER fallback)
_GIVEN_NAMES = {
    "james", "john", "robert", "michael", "william", "david", "richard",
    "joseph", "thomas", "charles", "christopher", "daniel", "matthew",
    "anthony", "mark", "donald", "steven", "paul", "andrew", "joshua",
    "kenneth", "kevin", "brian", "george", "edward", "ronald", "timothy",
    "jason", "jeffrey", "ryan", "jacob", "gary", "nicholas", "eric",
    "jonathan", "stephen", "larry", "justin", "scott", "brandon",
    "benjamin", "samuel", "gregory", "frank", "alexander", "raymond",
    "patrick", "jack", "dennis", "jerry", "peter", "henry", "adam",
    "mary", "patricia", "jennifer", "linda", "elizabeth", "barbara",
    "susan", "jessica", "sarah", "karen", "nancy", "lisa", "betty",
    "margaret", "sandra", "ashley", "kimberly", "emily", "donna",
    "michelle", "dorothy", "carol", "amanda", "melissa", "deborah",
    "stephanie", "rebecca", "sharon", "laura", "cynthia", "kathleen",
    "amy", "angela", "shirley", "anna", "brenda", "pamela", "emma",
    "nicole", "helen", "samantha", "katherine", "christine", "debra",
    "rachel", "catherine", "carolyn", "janet", "ruth", "maria",
    "heather", "diane", "virginia", "julie", "joyce", "victoria",
    "olivia", "kelly", "christina", "alice", "julia", "grace", "sofia",
    "ahmed", "mohammed", "ali", "omar", "hassan", "fatima", "aisha",
    "wei", "jing", "li", "chen", "yuki", "hiroshi", "kenji", "sakura",
    "raj", "priya", "arjun", "ananya", "ivan", "dmitri", "olga",
    "natasha", "pierre", "marie", "jean", "sophie", "hans", "klaus",
    "ingrid", "carlos", "jose", "juan", "ana", "lucia", "marco",
    "giulia", "lars", "erik", "astrid",
}
#: verbs/cues whose capitalized neighbor is very likely a Person
_PERSON_CUE_AFTER = {"said", "says", "told", "met", "asked", "replied",
                     "wrote", "argued", "announced", "stated", "noted",
                     "added", "explained", "warned"}
#: prepositions whose capitalized object is very likely a Location
_LOC_PREPS = {"in", "at", "from", "near", "to", "toward", "towards"}
#: connectors allowed INSIDE a multi-token proper-noun span
_SPAN_CONNECTORS = {"of", "the", "de", "da", "del", "della", "van",
                    "von", "bin", "al", "el", "la", "le"}
_MONTHS = {"january", "february", "march", "april", "may", "june", "july",
           "august", "september", "october", "november", "december",
           "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept",
           "oct", "nov", "dec"}
_WEEKDAYS = {"monday", "tuesday", "wednesday", "thursday", "friday",
             "saturday", "sunday"}

_TIME_RE = re.compile(r"^\d{1,2}:\d{2}(:\d{2})?([ap]m)?$", re.IGNORECASE)
_MONEY_RE = re.compile(r"^[$€£¥]\d[\d,.]*[kmb]?$", re.IGNORECASE)
_PCT_RE = re.compile(r"^\d[\d,.]*%$")
_YEAR_RE = re.compile(r"^(1[89]|20)\d\d$")
_SENT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z0-9\"'(])")
_TOKEN_RE = re.compile(r"[^\s]+")


def split_sentences(text: str) -> List[str]:
    """Sentence split on terminal punctuation followed by a capital,
    with abbreviation/honorific periods rejoined ("Dr. Alice" is not a
    boundary) — the reference OpenNLPSentenceSplitter's role."""
    text = (text or "").strip()
    if not text:
        return []
    parts = [s for s in _SENT_RE.split(text) if s]
    merged: List[str] = []
    no_break = _HONORIFICS | _ORG_SUFFIXES | {"no.", "vs.", "etc.", "e.g.",
                                              "i.e.", "jr.", "sr."}
    for part in parts:
        if merged and merged[-1].rsplit(None, 1)[-1].lower() in no_break:
            merged[-1] += " " + part
        else:
            merged.append(part)
    return merged


def _strip(tok: str) -> str:
    return tok.strip(".,;:!?\"'()[]{}")


def _is_cap(tok: str) -> bool:
    return bool(tok) and (tok[:1].isupper() and not tok.isupper()
                          or (tok.isupper() and len(tok) > 1))


class HeuristicNameEntityTagger:
    """tag(sentence) -> {token: {entity types}}
    (reference NameEntityTagger.tag returning TaggerResult.tokenTags).

    Gazetteer and context tagger: capitalized spans are assembled first (connector words
    like "of"/"van" allowed inside), then each span is classified by —
    in priority order — corporate suffix (Organization), location
    gazetteer (Location), honorific / given-name gazetteer / reporting-
    verb context (Person), locative preposition (Location). Numeric
    patterns (time/money/percent/date) tag independently per token."""

    def tag(self, sentence: str,
            entities: Sequence[str] = NameEntityType.values
            ) -> Dict[str, Set[str]]:
        raw = _TOKEN_RE.findall(sentence or "")
        toks = [_strip(t) for t in raw]
        lows = [t.lower() for t in toks]
        tags: Dict[str, Set[str]] = {}
        want = set(entities)

        def add(token: str, ent: str) -> None:
            if ent in want and token:
                tags.setdefault(token, set()).add(ent)

        # numeric / calendar patterns, token-local
        for tok, low in zip(toks, lows):
            if _TIME_RE.match(tok):
                add(tok, NameEntityType.Time)
            if _MONEY_RE.match(tok):
                add(tok, NameEntityType.Money)
            if _PCT_RE.match(tok):
                add(tok, NameEntityType.Percentage)
            if low in _MONTHS or low in _WEEKDAYS or _YEAR_RE.match(tok):
                add(tok, NameEntityType.Date)

        # assemble capitalized spans (connectors allowed inside)
        spans: List[Tuple[int, int]] = []      # [start, end) token idx
        i = 0
        n = len(toks)
        while i < n:
            if _is_cap(toks[i]) and lows[i] not in _HONORIFICS:
                j = i + 1
                while j < n and (
                        _is_cap(toks[j])
                        or (lows[j] in _SPAN_CONNECTORS and j + 1 < n
                            and _is_cap(toks[j + 1]))):
                    j += 1
                spans.append((i, j))
                i = j
            else:
                i += 1

        worklist = list(spans)
        while worklist:
            start, end = worklist.pop(0)
            span_lows = lows[start:end]
            span_toks = [t for t in toks[start:end] if t]
            prev = lows[start - 1] if start else ""
            is_sent_start = start == 0

            def add_span(ent: str, skip_connectors: bool = True,
                         _s=start, _e=end) -> None:
                for t, lo in zip(toks[_s:_e], lows[_s:_e]):
                    # only LOWERCASE connectors are glue ("Jean de la
                    # Fontaine"); a capitalized homograph is part of
                    # the name itself ("Al Gore", "La Paz")
                    if (skip_connectors and lo in _SPAN_CONNECTORS
                            and not _is_cap(t)):
                        continue
                    add(t, ent)

            # 0. a connector-bridged span opening with PERSON evidence
            #    ("Dr. Alice Smith of Acme Corp") splits at the first
            #    connector: the head is the person, the tail re-enters
            #    classification on its own
            if prev in _HONORIFICS or span_lows[0] in _GIVEN_NAMES:
                split = next((c for c, lo in enumerate(span_lows)
                              if lo in _SPAN_CONNECTORS
                              and not _is_cap(toks[start + c])), None)
                if split is not None:
                    for t in toks[start:start + split]:
                        add(t, NameEntityType.Person)
                    worklist.insert(0, (start + split + 1, end))
                    continue

            # 1. corporate suffix anywhere in span -> Organization
            if any(lo in _ORG_SUFFIXES for lo in span_lows):
                add_span(NameEntityType.Organization,
                         skip_connectors=False)
                continue
            # 2. location gazetteer hit -> Location
            if any(lo in _LOCATIONS for lo in span_lows):
                add_span(NameEntityType.Location)
                continue
            # 3. Person evidence: honorific before, given-name first
            #    token, or a reporting verb adjacent
            nxt = lows[end] if end < n else ""
            if (prev in _HONORIFICS
                    or span_lows[0] in _GIVEN_NAMES
                    or nxt in _PERSON_CUE_AFTER
                    or prev in _PERSON_CUE_AFTER):
                add_span(NameEntityType.Person)
                continue
            # 4. locative preposition before a non-sentence-initial span
            if prev in _LOC_PREPS and not is_sent_start:
                add_span(NameEntityType.Location)
                continue
            # 5. multi-token capitalized span mid-sentence, no other
            #    evidence -> likely Person (OpenNLP's majority case)
            if not is_sent_start and len(span_toks) >= 2:
                add_span(NameEntityType.Person)
        return tags
