# Frozen copy of seqlib_tpu_torch/core/header.py for the benchmark's reference
# (plain PyTorch path only): later changes to the port do not reach it.
"""BamHeader: SAM/BAM sequence dictionary + header text (counterpart of
seqlib_tpu/core/header.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class HeaderSequence:
    """One @SQ entry."""

    name: str
    length: int


class BamHeader:
    """Sequence dictionary + full SAM header text, built from SAM text,
    from a list of HeaderSequence / (name, length), or empty."""

    def __init__(self, arg=None):
        self._text = ""
        self._names: list[str] = []
        self._lengths: list[int] = []
        self._name2id: dict[str, int] = {}
        if arg is None:
            return
        if isinstance(arg, str):
            self._from_text(arg)
        else:
            seqs = []
            for s in arg:
                if isinstance(s, HeaderSequence):
                    seqs.append((s.name, s.length))
                else:
                    seqs.append((str(s[0]), int(s[1])))
            self._from_sequences(seqs)

    def _from_sequences(self, seqs: list[tuple[str, int]]) -> None:
        lines = ["@HD\tVN:1.4"]
        for name, ln in seqs:
            lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
        self._text = "\n".join(lines) + "\n"
        for name, ln in seqs:
            self._add_seq(name, ln)

    def _from_text(self, text: str) -> None:
        self._text = text
        for line in text.splitlines():
            if line.startswith("@SQ"):
                name, ln = None, None
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if name is not None and ln is not None:
                    self._add_seq(name, ln)

    def _add_seq(self, name: str, length: int) -> None:
        self._name2id[name] = len(self._names)
        self._names.append(name)
        self._lengths.append(length)

    def is_empty(self) -> bool:
        """True when constructed empty."""
        return not self._names and not self._text

    def num_sequences(self) -> int:
        return len(self._names)

    def name2id(self, name: str) -> int:
        """Name -> reference id, -1 if not found."""
        return self._name2id.get(name, -1)

    def id2name(self, tid: int) -> str:
        """Reference id -> name; raises IndexError when out of range."""
        if tid < 0 or tid >= len(self._names):
            raise IndexError(
                f"BamHeader.id2name - id {tid} out of range "
                f"(n={len(self._names)})")
        return self._names[tid]

    def get_sequence_length(self, ref) -> int:
        """Sequence length by id or name, -1 if unknown."""
        if isinstance(ref, str):
            ref = self.name2id(ref)
        if ref < 0 or ref >= len(self._lengths):
            return -1
        return self._lengths[ref]

    def as_string(self) -> str:
        """Full SAM header text."""
        return self._text

    def sequences(self) -> list[HeaderSequence]:
        return [HeaderSequence(n, l)
                for n, l in zip(self._names, self._lengths)]

    # the reference API's names
    IDtoName = id2name
    Name2ID = name2id

    def __len__(self) -> int:
        return len(self._names)

    def __eq__(self, other) -> bool:
        return isinstance(other, BamHeader) and self._text == other._text

    def __repr__(self) -> str:
        return f"BamHeader({len(self._names)} sequences)"
