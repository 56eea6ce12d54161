"""Seeded BARE-EXCEPT-SWALLOW violations (never imported)."""


def apply_frames(frames, node):
    for f in frames:
        try:
            node.apply(f)
        except Exception:          # BARE-EXCEPT-SWALLOW: hides apply
            pass                   # failures in a replication path


def cleanup(path):
    import os
    try:
        os.unlink(path)
    except OSError:                # clean: narrowed to fs errors
        pass


class Thing:
    def __del__(self):
        try:
            self.close()
        except Exception:          # clean: __del__ is exempt
            pass
