"""Legacy H-PoP fragment file interop.

Reader for frags.txt files (file_reader.rs:37-109) and the matching writer
(file_writer.rs:665-696): `n_blocks  id  start1 alleles1  start2 alleles2
...  quals(+33)`. Kept for interoperability with other haplotypers; the
core pipeline ingests BAM+VCF directly.
"""

from __future__ import annotations

from typing import Dict, List

from ..frag import Frag


def read_frags_file(path: str) -> Dict[str, List[Frag]]:
    all_frags: List[Frag] = []
    counter = 0
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            v = line.split("\t")
            num_blocks = int(v[0])
            frag = Frag(v[1], counter, is_paired=False)
            positions: List[int] = []
            for i in range(num_blocks):
                start = int(v[2 * i + 2])
                for j, ch in enumerate(v[2 * i + 3]):
                    pos = start + j
                    frag.seq_dict[pos] = int(ch)
                    positions.append(pos)
            quals = v[-1]
            for pos, q in zip(positions, quals):
                frag.qual_dict[pos] = ord(q) - 33
            for pos in positions:
                frag.snp_pos_to_seq_pos.setdefault(pos, (0, 0))
            frag.first_position = positions[0]
            frag.last_position = positions[-1]
            all_frags.append(frag)
            counter += 1
    return {"frag_contig": all_frags}


def write_frags_file(frags: List[Frag], path: str) -> None:
    with open(path, "w") as fh:
        for frag in frags:
            positions = sorted(frag.seq_dict)
            blocks: List[List[int]] = []
            starts: List[int] = []
            prev = None
            for pos in positions:
                if prev is None or pos - prev > 1:
                    blocks.append([frag.seq_dict[pos]])
                    starts.append(pos)
                else:
                    blocks[-1].append(frag.seq_dict[pos])
                prev = pos
            fh.write(f"{len(blocks)}\t{frag.id}\t")
            for start, block in zip(starts, blocks):
                fh.write(f"{start}\t" + "".join(str(a) for a in block)
                         + "\t")
            for pos in positions:
                q = frag.qual_dict[pos]
                fh.write(chr(q) if q + 33 > 255 else chr(q + 33))
            fh.write("\n")
