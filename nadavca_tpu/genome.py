"""Reference genome handling: FASTA load, integer encoding, reverse complement.

Parity target: the reference's ``Genome`` loader (SURVEY.md component
inventory, "Reference genome loader" row — reconstructed; the reference mount
was empty so no file:line citation is possible). Capabilities reproduced:
FASTA parsing into contigs, reverse complement, integer base encoding, and
k-mer window extraction.

Device note: all encoding is vectorized numpy producing flat ``int8``/
``int32`` arrays that device code consumes directly; nothing here runs on
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

# Base encoding. A=0 C=1 G=2 T=3; anything else (N, ambiguity codes) -> 4.
_ENCODE_LUT = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _ENCODE_LUT[ord(_b)] = _i
    _ENCODE_LUT[ord(_b.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode_bases(seq: str | bytes) -> np.ndarray:
    """Encode an ACGT string to int8 codes (A=0,C=1,G=2,T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_bases(codes: np.ndarray) -> str:
    """Inverse of :func:`encode_bases`."""
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an encoded sequence."""
    return _COMPLEMENT[codes[::-1]]


def kmer_ids(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mer ids of an encoded sequence; len = len(codes) - k + 1.

    kmer id = big-endian base-4 integer of the k bases. Windows containing a
    non-ACGT base get id -1.
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int32)
    ids = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=bool)
    for off in range(k):
        w = codes[off : off + n].astype(np.int64)
        bad |= w > 3
        ids = ids * 4 + np.clip(w, 0, 3)
    ids[bad] = -1
    return ids.astype(np.int32)


@dataclasses.dataclass
class Contig:
    name: str
    codes: np.ndarray  # int8 encoded bases

    def __len__(self) -> int:
        return len(self.codes)

    @property
    def sequence(self) -> str:
        return decode_bases(self.codes)


class Genome:
    """A loaded reference genome: ordered contigs of encoded bases."""

    def __init__(self, contigs: List[Contig]):
        self.contigs = contigs
        self._by_name: Dict[str, Contig] = {c.name: c for c in contigs}

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        contigs: List[Contig] = []
        name = None
        chunks: List[bytes] = []
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    if name is not None:
                        contigs.append(Contig(name, encode_bases(b"".join(chunks))))
                    name = line[1:].split()[0].decode("ascii")
                    chunks = []
                else:
                    chunks.append(line)
        if name is not None:
            contigs.append(Contig(name, encode_bases(b"".join(chunks))))
        return cls(contigs)

    @classmethod
    def from_dict(cls, seqs: Dict[str, str]) -> "Genome":
        return cls([Contig(n, encode_bases(s)) for n, s in seqs.items()])

    def __getitem__(self, name: str) -> Contig:
        return self._by_name[name]

    def __iter__(self) -> Iterator[Contig]:
        return iter(self.contigs)

    def __len__(self) -> int:
        return len(self.contigs)

    def to_fasta(self, path: str, width: int = 70) -> None:
        with open(path, "w") as f:
            for c in self.contigs:
                f.write(f">{c.name}\n")
                s = c.sequence
                for i in range(0, len(s), width):
                    f.write(s[i : i + width] + "\n")

    def window(self, name: str, start: int, end: int, strand: int = +1) -> np.ndarray:
        """Encoded bases of [start, end) on the given strand (+1/-1).

        For strand=-1 the window is reverse-complemented, so the result always
        reads 5'->3' in the direction the read traverses it.
        """
        codes = self._by_name[name].codes[start:end]
        return reverse_complement(codes) if strand < 0 else codes
