"""Messages encrypted plus answers decrypted, over the window's seconds."""


def read(rec):
    return rec.items / rec.elapsed if rec.elapsed > 0 else None
