from .seqs import (
    encode,
    decode,
    revcomp,
    revcomp_encoded,
    phred_to_array,
    array_to_phred,
    round_to_base,
    BASE_A, BASE_C, BASE_G, BASE_T, BASE_N,
)
