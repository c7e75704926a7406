"""Aho-Corasick multi-pattern matcher (counterpart of
seqlib_tpu/filters/ahocorasick.py).

The trie SeqLib's ReadFilter uses for motif rules: a goto/fail
automaton, failure links by BFS; ``parse_text`` returns all (start,
end, pattern) matches.
"""

from __future__ import annotations

from collections import deque


class AhoCorasickTrie:
    def __init__(self):
        self._goto: list[dict[str, int]] = [{}]
        self._fail: list[int] = [0]
        self._out: list[list[str]] = [[]]
        self._built = False
        self.count = 0

    def insert(self, pattern: str) -> None:
        if not pattern:
            return
        node = 0
        for ch in pattern:
            nxt = self._goto[node].get(ch)
            if nxt is None:
                nxt = len(self._goto)
                self._goto.append({})
                self._fail.append(0)
                self._out.append([])
                self._goto[node][ch] = nxt
            node = nxt
        self._out[node].append(pattern)
        self.count += 1
        self._built = False

    def _build(self) -> None:
        q = deque()
        for ch, nxt in self._goto[0].items():
            self._fail[nxt] = 0
            q.append(nxt)
        while q:
            node = q.popleft()
            for ch, nxt in self._goto[node].items():
                q.append(nxt)
                f = self._fail[node]
                while f and ch not in self._goto[f]:
                    f = self._fail[f]
                self._fail[nxt] = self._goto[f].get(ch, 0)
                if self._fail[nxt] == nxt:
                    self._fail[nxt] = 0
                self._out[nxt] = self._out[nxt] \
                    + self._out[self._fail[nxt]]
        self._built = True

    def parse_text(self, text: str) -> list[tuple[int, int, str]]:
        """All matches as (start, end_inclusive, pattern)."""
        if not self._built:
            self._build()
        out = []
        node = 0
        for i, ch in enumerate(text):
            while node and ch not in self._goto[node]:
                node = self._fail[node]
            node = self._goto[node].get(ch, 0)
            for pat in self._out[node]:
                out.append((i - len(pat) + 1, i, pat))
        return out


class AhoCorasick:
    """SeqLib's Filter::AhoCorasick: TrieFromFile + QueryText -> match
    count."""

    def __init__(self):
        self.trie = AhoCorasickTrie()
        self.inv = False
        self.count = 0
        self.file = ""

    def add_motif(self, m: str) -> None:
        self.trie.insert(m)

    def trie_from_file(self, path: str) -> None:
        self.file = path
        try:
            with open(path) as fh:
                for line in fh:
                    pat = line.rstrip("\n")
                    if pat:
                        self.count += 1
                        self.trie.insert(pat)
        except OSError as e:
            raise RuntimeError(
                f"AhoCorasick::TrieFromFile - Cannot read file: {path}"
            ) from e

    def query_text(self, t: str) -> int:
        return len(self.trie.parse_text(t))

    TrieFromFile = trie_from_file
    QueryText = query_text
