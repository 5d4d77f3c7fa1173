"""Share of the alignment's lattice states that lie inside the labels, in
percent: the program's counters ``recon.lattice_used`` (each line's 2L + 1
states) over ``recon.lattice_slots`` (batch x the padded labels' states,
which the recursion carries)."""

from harness import program_spans


def read(m):
    return program_spans.fill(m, "recon.lattice_used", "recon.lattice_slots")
