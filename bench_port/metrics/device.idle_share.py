"""1 - the device's busy seconds over the traced chunks' host seconds, in
%."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or prof["busy_s"] <= 0:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
