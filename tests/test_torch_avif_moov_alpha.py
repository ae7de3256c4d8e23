"""The moov sweep of test_torch_avif_moov.py on an RGBA animation: its
colour track and its alpha track (tref auxl to the colour track, an auxi
with the alpha URN in its av01 sample entry). libavif's alpha rules
read off PIL's answers: the alpha track needs chunks and, where its
sample entry has an auxi, the alpha URN (else the file reads as RGB); it
needs no av1C; its tkhd size must equal the colour track's (else
Pillow's "Decoding of alpha plane failed"); every trak needs a tkhd of
version 0 or 1 with a size inside libavif's limits.
"""

import pytest

from test_torch_avif_moov import cases, check_edit, edits

DATA, BOXES = cases(4)


@pytest.mark.parametrize("box", sorted(BOXES))
def test_rgba_moov_edits_read_as_pil_reads_them(tmp_path, box):
    seen = set()
    for pos, data in edits(DATA, *BOXES[box]):
        try:
            seen.add(check_edit(tmp_path / "edit.avif", data))
        except AssertionError as e:
            raise AssertionError(f"{box} byte {pos - BOXES[box][0]}: "
                                 f"{e}") from None
    assert seen


def test_the_sweep_covers_the_alpha_track():
    names = {k.rsplit("/", 1)[-1].split("#")[0] for k in BOXES}
    assert {"tref", "auxl", "auxi", "prem"} & names >= {"tref", "auxl",
                                                        "auxi"}, names
    assert sum(1 for k in BOXES if k.rsplit("/", 1)[-1].startswith("trak#")
               and k.count("/") == 2) == 2
