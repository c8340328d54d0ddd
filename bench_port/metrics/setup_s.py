"""Seconds from the process's start to the first timed step."""


def read(ctx):
    return ctx["setup_s"]
