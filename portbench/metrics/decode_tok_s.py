"""decode_tok_s: every output token of the window over the window's wall
time (host clock), the card idle at both ends."""


def read(w):
    return w.output_tokens() / w.seconds if w.seconds > 0 else None
