"""Set-up: seeded weights and inputs, the program built, its kernels
built and its graphs captured on every shape of the mix (host clock)."""


def read(rec):
    return rec.setup_s
