"""Memoization of computed styles per (entity kind, relevant tags, zoom).

Mirrors `src/mapcss/style_cache.rs`: the cache key is the entity's cache
slot (node 0 / closed way 1 / open way 2 / multipolygon 3), the zoom,
and the *string-pool offsets* of the entity's tags that any selector
cares about — including the value offset only when some test depends on
the tag's value (not just its existence).  String-pool offsets uniquely
identify strings, so this is an exact key.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

from tilebench.ref.mapcss.parser import Rule, UnaryTest, UnaryTestType


class StyleCache:
    def __init__(self, rules: List[Rule]):
        tag_value_matters: Dict[str, bool] = {"layer": True}
        for r in rules:
            for sel in r.selectors:
                for test in sel.tests:
                    if isinstance(test, UnaryTest):
                        value_matters = test.test_type not in (
                            UnaryTestType.EXISTS,
                            UnaryTestType.NOT_EXISTS,
                        )
                        name = test.tag_name
                    else:
                        value_matters = True
                        name = test.tag_name
                    tag_value_matters[name] = tag_value_matters.get(name, False) | value_matters
        self.tag_value_matters = tag_value_matters
        # Lazily-built map from key string-pool offset -> (interesting, value_matters).
        self._offset_decision: Dict[int, Optional[bool]] = {}
        self._cache: Dict[Tuple, list] = {}
        # Entity-identity memo over the key itself: the same mmap'd way
        # is styled in up to 9 neighboring tiles, and its tags (hence
        # key) cannot change.  Weakly keyed by the reader so entities
        # from different geodata files never collide.
        self._key_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _decide(self, tags, k_off: int, k_len: int) -> Optional[bool]:
        cached = self._offset_decision.get(k_off, "missing")
        if cached != "missing":
            return cached
        key = bytes(tags.strings[k_off : k_off + k_len]).decode("utf-8")
        decision = self.tag_value_matters.get(key)
        self._offset_decision[k_off] = decision
        return decision

    def _key(self, entity, zoom: int) -> Tuple:
        from tilebench.ref.mapcss.styler import cache_slot

        memo = self._key_memo.get(entity.reader)
        if memo is None:
            memo = {}
            self._key_memo[entity.reader] = memo
        mk = (entity.__class__, entity.local_id, zoom)
        got = memo.get(mk)
        if got is not None:
            return got

        tags = entity.tags()
        parts: List[int] = []
        for row in tags.key_value_offsets():
            decision = self._decide(tags, int(row[0]), int(row[1]))
            if decision is not None:
                parts.append(int(row[0]))
                if decision:
                    parts.append(int(row[2]))
        key = (cache_slot(entity), tuple(parts), zoom)
        memo[mk] = key
        return key

    def get(self, entity, zoom: int):
        return self._cache.get(self._key(entity, zoom))

    def insert(self, entity, zoom: int, styles: list) -> None:
        self._cache[self._key(entity, zoom)] = styles
