"""Locale validation.

Reference: meilisearch-types/src/locales.rs — the `locales` search/facet
parameter and `localizedAttributes` setting accept ISO-639-1/639-3 codes
(plus `cmn`); unknown values error deserr-style with the full expected
list in declaration order (pinned by tests/search/locales.rs:958
invalid_locales / :993 invalid_localized_attributes_rules).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .errors import EngineError, ErrorCode

# declaration order matters: the deserr error message enumerates the
# enum variants in this exact order (locales.rs make_locale! invocation)
_ORDERED_LOCALES = (
    "af ak am ar az be bn bg ca cs da de el en eo et fi fr gu he hi hr hu"
    " hy id it jv ja kn ka km ko la lv lt ml mr mk my ne nl nb or pa fa pl"
    " pt ro ru si sk sl sn es sr sv ta te tl th tk tr uk ur uz vi yi zh zu"
    " afr aka amh ara aze bel ben bul cat ces dan deu ell eng epo est fin"
    " fra guj heb hin hrv hun hye ind ita jav jpn kan kat khm kor lat lav"
    " lit mal mar mkd mya nep nld nob ori pan pes pol por ron rus sin slk"
    " slv sna spa srp swe tam tel tgl tha tuk tur ukr urd uzb vie yid zho"
    " zul cmn"
).split()

VALID_LOCALES = frozenset(_ORDERED_LOCALES)

_EXPECTED = ", ".join(f"`{loc}`" for loc in _ORDERED_LOCALES)


def validate_locales(
    locales: Optional[Iterable],
    code: ErrorCode = ErrorCode.INVALID_SEARCH_LOCALES,
    field: str = ".locales",
) -> Optional[list[str]]:
    if locales is None:
        return None
    if not isinstance(locales, (list, tuple)):
        raise EngineError(
            code,
            f"Invalid value type at `{field}`: expected an array of locale"
            " strings.",
        )
    out = []
    for i, loc in enumerate(locales):
        if not isinstance(loc, str) or loc not in VALID_LOCALES:
            raise EngineError(
                code,
                f"Unknown value `{loc}` at `{field}[{i}]`: expected one of"
                f" {_EXPECTED}",
            )
        out.append(loc)
    return out
