"""train.setup_host_s: the Trainer's host set-up (mirror padding, the
position tables, the upload), the sum of `Trainer.setup_s`."""


def read(r):
    parts = r.program.get("setup_host_s")
    return None if not parts else sum(parts.values())
