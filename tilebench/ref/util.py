def next_pow2(n: int, minimum: int = 1) -> int:
    v = max(n, minimum)
    return 1 << (v - 1).bit_length()
