"""text_tower_ms: the time (ms) of the program's ``atsm.model.text_tower``
spans / the sessions completed on a prompt never seen: the inside
counterpart of new_prompt_open_ms."""

from port_bench import spans


def read(run):
    return spans.span_ms(run, ["atsm.model.text_tower"],
                         sum(1 for r in run.ok() if r.get("new_prompt")))
