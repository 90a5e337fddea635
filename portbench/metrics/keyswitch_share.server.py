"""Share (%) of the traced window's device time in the key switch's two
transform launches (registry family `keyswitch`: k_stage_fwd_block_ks, the
digits' forwards, and k_stage_inv_block_ks, the accumulate's inverse)."""

from portbench.harness.families import family_share


def read(rec):
    return family_share(rec, "keyswitch")
