"""images_per_step.train: images in each step's batch, counted on the device as the step starts, the
mean over the window's steps (the trainer's `images_per_batch` for the same batch)."""


def read(cell, counters):
    steps = counters.get("images_per_step")
    return sum(steps) / len(steps) if steps else None
