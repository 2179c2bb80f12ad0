"""ct_per_s: client ciphertexts aggregated per second — clients ×
ciphertexts a client × rounds completed in the window, over the window's
seconds (host clock)."""


def read(rec):
    return rec.work.clients * rec.work.batch * rec.rounds / rec.window_s
