"""Device kernels (copies and fills left out) in the traced window, a pair."""


def read(rec):
    n = sum(1 for k, _, _, _ in rec.kernels
            if not k.startswith(("Memcpy", "Memset")))
    return n / rec.pairs if rec.pairs and n else None
