"""Seconds of the first ``train_chunk`` (the eager warm-up update, the
capture and instantiation of the update's graph, the replays), by the host
clock after a device sync: the part of ``setup_s`` that the trainer owns."""


def read(context):
    return context.get("first_launch_s")
