"""Share (%) of the traced window's device time in the BEHZ conversions
(registry family `behz`: k_behz, rns_to_bsk and scale_and_round)."""

from portbench.harness.families import family_share


def read(rec):
    return family_share(rec, "behz")
