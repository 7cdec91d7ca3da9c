"""Seconds of the walk a training job: the program's ``train/walk`` span (it
waits for the walk's result on the card), the mean over the traced run's
jobs after the profiled ones."""

import statistics


def read(ctx):
    spans = [s["train/walk"] for s in ctx["spans"] if "train/walk" in s]
    return statistics.fmean(spans) if spans else None
