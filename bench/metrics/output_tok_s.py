"""output_tok_s (tokens/s, host clock): tokens the engine served in the
window over the window's length; a request's first token (from its
admission prefill) counts with the rest."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.tokens / run.window_s
