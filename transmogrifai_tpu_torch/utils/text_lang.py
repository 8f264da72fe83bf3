"""Language identification: Unicode-script routing and character n-gram
profiles.

The port's copy of ``transmogrifai_tpu/utils/text_lang.py``: the two-stage
design of real detectors (the reference ships Optimaize language
detection, core/build.gradle, an n-gram profile model).

1. **Script routing.** A Unicode-block histogram decides the script;
   single-script languages resolve at once (Hangul -> ko, kana -> ja, Han
   without kana -> zh, Greek -> el, Arabic -> ar, Hebrew -> he,
   Devanagari -> hi, Thai -> th).
2. **Cavnar-Trenkle rank-order n-gram profiles** for languages that share
   a script (Latin: en/fr/de/es/it/pt/nl; Cyrillic: ru/uk): the character
   1-3-gram frequency ranks of the input against per-language profiles,
   by out-of-place distance. The profiles are built at import from the
   embedded seed prose, the JAX package's.

Host-side, pure Python: language detection runs in the host text
pipeline, as in the JAX package.
"""
from __future__ import annotations

import re
import unicodedata
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["detect_language", "dominant_script", "ngram_profile",
           "profile_distance"]

# ---------------------------------------------------------------------------
# script routing
# ---------------------------------------------------------------------------

_SCRIPT_RANGES = (
    ("han", 0x4E00, 0x9FFF), ("han", 0x3400, 0x4DBF),
    ("hiragana", 0x3040, 0x309F), ("katakana", 0x30A0, 0x30FF),
    ("hangul", 0xAC00, 0xD7AF), ("hangul", 0x1100, 0x11FF),
    ("cyrillic", 0x0400, 0x04FF),
    ("greek", 0x0370, 0x03FF),
    ("arabic", 0x0600, 0x06FF), ("arabic", 0x0750, 0x077F),
    ("hebrew", 0x0590, 0x05FF),
    ("devanagari", 0x0900, 0x097F),
    ("thai", 0x0E00, 0x0E7F),
    ("latin", 0x0041, 0x024F),
)


def _char_script(ch: str) -> Optional[str]:
    cp = ord(ch)
    for name, lo, hi in _SCRIPT_RANGES:
        if lo <= cp <= hi:
            return name
    return None


def dominant_script(text: str) -> Optional[str]:
    """Most frequent script among letter characters; None if no letters."""
    counts: Counter = Counter()
    for ch in text:
        if ch.isalpha():
            s = _char_script(ch)
            if s:
                counts[s] += 1
    if not counts:
        return None
    return counts.most_common(1)[0][0]


#: scripts that identify a language on their own (the ambiguity left —
#: e.g. Han covers zh AND ja kanji — is resolved below)
_SCRIPT_LANG = {"hangul": "ko", "greek": "el", "arabic": "ar",
                "hebrew": "he", "devanagari": "hi", "thai": "th"}

# ---------------------------------------------------------------------------
# Cavnar–Trenkle profiles
# ---------------------------------------------------------------------------

#: embedded seed prose per Latin/Cyrillic language (ordinary sentences
#: composed for this table; everyday vocabulary so the character
#: statistics are representative)
_SEED_TEXT = {
    "en": ("the quick brown fox jumps over the lazy dog. she said that "
           "they would come to the house in the morning and bring with "
           "them all the things that we had asked for. it is not what "
           "you know but who you know. there are many people who think "
           "that the world would be better with more kindness and this "
           "is something we can all agree with. when the weather is "
           "good the children play outside until the evening."),
    "fr": ("le chien et le chat sont dans le jardin de la maison. elle a "
           "dit qu'ils viendraient demain matin avec toutes les choses "
           "que nous avions demandées. ce n'est pas ce que vous savez "
           "mais qui vous connaissez. il y a beaucoup de gens qui "
           "pensent que le monde serait meilleur avec plus de "
           "gentillesse et c'est quelque chose que nous pouvons tous "
           "accepter. quand il fait beau les enfants jouent dehors "
           "jusqu'au soir."),
    "de": ("der schnelle braune fuchs springt über den faulen hund. sie "
           "sagte dass sie morgen früh kommen würden und alle dinge "
           "mitbringen die wir verlangt hatten. es ist nicht was du "
           "weißt sondern wen du kennst. es gibt viele menschen die "
           "denken dass die welt mit mehr freundlichkeit besser wäre "
           "und dem können wir alle zustimmen. wenn das wetter schön "
           "ist spielen die kinder draußen bis zum abend. guten morgen "
           "und guten abend sagen die leute hier jeden tag. ich habe "
           "heute keine zeit aber vielleicht können wir nächste woche "
           "zusammen essen gehen. das buch liegt auf dem tisch neben "
           "dem fenster und gehört meinem bruder."),
    "es": ("el perro y el gato están en el jardín de la casa. ella dijo "
           "que vendrían mañana por la mañana y traerían todas las "
           "cosas que habíamos pedido. no es lo que sabes sino a quién "
           "conoces. hay mucha gente que piensa que el mundo sería "
           "mejor con más amabilidad y es algo con lo que todos podemos "
           "estar de acuerdo. cuando hace buen tiempo los niños juegan "
           "afuera hasta la noche."),
    "it": ("il cane e il gatto sono nel giardino della casa. ha detto "
           "che sarebbero venuti domani mattina e avrebbero portato "
           "tutte le cose che avevamo chiesto. non è quello che sai ma "
           "chi conosci. ci sono molte persone che pensano che il mondo "
           "sarebbe migliore con più gentilezza e questo è qualcosa su "
           "cui tutti possiamo essere d'accordo. quando il tempo è "
           "bello i bambini giocano fuori fino a sera."),
    "pt": ("o cão e o gato estão no jardim da casa. ela disse que "
           "viriam amanhã de manhã e trariam todas as coisas que "
           "tínhamos pedido. não é o que você sabe mas quem você "
           "conhece. há muitas pessoas que pensam que o mundo seria "
           "melhor com mais gentileza e isso é algo com que todos "
           "podemos concordar. quando o tempo está bom as crianças "
           "brincam lá fora até a noite."),
    "nl": ("de snelle bruine vos springt over de luie hond. ze zei dat "
           "ze morgenochtend zouden komen en alle dingen meebrengen "
           "waar we om hadden gevraagd. het is niet wat je weet maar "
           "wie je kent. er zijn veel mensen die denken dat de wereld "
           "beter zou zijn met meer vriendelijkheid en daar kunnen we "
           "het allemaal mee eens zijn. als het weer mooi is spelen de "
           "kinderen buiten tot de avond. goedemorgen en goedenavond "
           "zeggen de mensen hier elke dag. ik heb vandaag geen tijd "
           "maar misschien kunnen we volgende week samen uit eten "
           "gaan. het boek ligt op de tafel naast het raam en is van "
           "mijn broer."),
    "ru": ("быстрая коричневая лиса прыгает через ленивую собаку. она "
           "сказала что они придут завтра утром и принесут все вещи "
           "которые мы просили. важно не то что ты знаешь а кого ты "
           "знаешь. есть много людей которые думают что мир был бы "
           "лучше с большей добротой и с этим мы все можем "
           "согласиться. когда погода хорошая дети играют на улице до "
           "вечера."),
    "uk": ("швидка коричнева лисиця стрибає через ледачого пса. вона "
           "сказала що вони прийдуть завтра вранці і принесуть усі "
           "речі які ми просили. важливо не те що ти знаєш а кого ти "
           "знаєш. є багато людей які думають що світ був би кращим з "
           "більшою добротою і з цим ми всі можемо погодитися. коли "
           "погода гарна діти граються надворі до вечора."),
}

_PROFILE_SIZE = 300
_SCRIPT_LANGS = {
    "latin": ("en", "fr", "de", "es", "it", "pt", "nl"),
    "cyrillic": ("ru", "uk"),
}


def _normalize(text: str) -> str:
    text = unicodedata.normalize("NFC", text.lower())
    return re.sub(r"[^\w\s']|\d", " ", text)


def ngram_profile(text: str, max_n: int = 3,
                  size: Optional[int] = _PROFILE_SIZE) -> List[str]:
    """Character 1..max_n-grams ranked by frequency (Cavnar–Trenkle);
    word-boundary padded with spaces as the original formulation."""
    counts: Counter = Counter()
    for word in _normalize(text).split():
        padded = f" {word} "
        for n in range(1, max_n + 1):
            for i in range(len(padded) - n + 1):
                g = padded[i:i + n]
                if not g.isspace():
                    counts[g] += 1
    ranked = [g for g, _ in counts.most_common(size)]
    return ranked


def profile_distance(doc_profile: List[str],
                     lang_profile: List[str]) -> int:
    """Out-of-place distance: sum over document n-grams of the rank
    difference vs the language profile (missing = max penalty)."""
    pos = {g: i for i, g in enumerate(lang_profile)}
    max_pen = len(lang_profile)
    return sum(abs(pos.get(g, max_pen) - i)
               for i, g in enumerate(doc_profile))


_PROFILES: Dict[str, List[str]] = {
    lang: ngram_profile(seed) for lang, seed in _SEED_TEXT.items()}


class _ScriptRanks:
    """``profile_distance`` of one document against every profile of a
    script's languages at once: the rank of each n-gram of the profiles'
    union in each profile (the profile's length where it is missing), an
    extra column of those penalties for n-grams in no profile. Integer
    sums, so each distance is ``profile_distance``'s exactly."""

    def __init__(self, langs: Tuple[str, ...]):
        self.langs = langs
        grams = sorted({g for lang in langs for g in _PROFILES[lang]})
        self.column = {g: j for j, g in enumerate(grams)}
        pen = np.array([len(_PROFILES[lang]) for lang in langs])
        self.ranks = np.repeat(pen[:, None], len(grams) + 1, axis=1)
        for r, lang in enumerate(langs):
            for i, g in enumerate(_PROFILES[lang]):
                self.ranks[r, self.column[g]] = i

    def distances(self, doc_profile: List[str]) -> Dict[str, int]:
        missing = len(self.column)
        cols = np.fromiter((self.column.get(g, missing)
                            for g in doc_profile), dtype=np.int64,
                           count=len(doc_profile))
        d = np.abs(self.ranks[:, cols]
                   - np.arange(len(doc_profile))).sum(axis=1)
        return {lang: int(v) for lang, v in zip(self.langs, d)}


_RANKS = {script: _ScriptRanks(langs)
          for script, langs in _SCRIPT_LANGS.items()}


def detect_language(text: Optional[str],
                    default: str = "unknown") -> Tuple[str, float]:
    """(language code, confidence in [0, 1]). Script-routed, n-gram
    resolved; ``default`` when the text carries no signal."""
    if not text or not text.strip():
        return default, 0.0
    script = dominant_script(text)
    if script is None:
        return default, 0.0
    if script in _SCRIPT_LANG:
        return _SCRIPT_LANG[script], 1.0
    if script in ("hiragana", "katakana"):
        return "ja", 1.0
    if script == "han":
        # Han + any kana = Japanese; pure Han = Chinese
        if any(_char_script(c) in ("hiragana", "katakana") for c in text):
            return "ja", 1.0
        return "zh", 0.9
    langs = _SCRIPT_LANGS.get(script)
    if not langs:
        return default, 0.0
    doc = ngram_profile(text, size=_PROFILE_SIZE)
    if not doc:
        return default, 0.0
    dists = _RANKS[script].distances(doc)
    ranked = sorted(dists.items(), key=lambda kv: kv[1])
    best, best_d = ranked[0]
    worst_d = max(len(doc) * _PROFILE_SIZE, 1)
    margin = ((ranked[1][1] - best_d) / max(ranked[1][1], 1)
              if len(ranked) > 1 else 1.0)
    confidence = max(0.0, min(1.0, 1.0 - best_d / worst_d)) * 0.5 \
        + min(1.0, margin * 5.0) * 0.5
    # a couple of words is weak evidence for same-script languages
    # (closely related pairs like de/nl need statistics to separate) —
    # damp the confidence so min_confidence gates can actually act on
    # short inputs instead of confidently-wrong labels
    confidence *= min(1.0, len(doc) / 80.0)
    return best, confidence
