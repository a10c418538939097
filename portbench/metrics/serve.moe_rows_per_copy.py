"""Expert rows the MoE layers computed over the token copies they routed
in the window (the engine's counters, ``ServeEngine.stats``: E x C rows
and N x K copies a layer and forward, from shapes): 1 where every
computed row is a routed copy; dropless at C = N, E / K at every forward."""


def read(record):
    c = record["counts"]
    rows, copies = c.get("moe_expert_rows"), c.get("moe_routed_copies")
    return rows / copies if rows and copies else None
