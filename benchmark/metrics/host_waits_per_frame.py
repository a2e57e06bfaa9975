"""Calls a frame that made the host wait for the card, counted by
PyTorch's sync debug mode around the frame's own code."""


def read(record):
    return record["waits"] / record["frames"]
