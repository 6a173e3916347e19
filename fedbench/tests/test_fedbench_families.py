"""A configuration or a mix that brings a mechanism the three cells do not
use needs files and data only: the family is found by name, the port's
config takes the file's ``port`` block as it stands, and the federated mix
reads its engine, its merge chunk and its share of clients. Each path runs
at a tiny size on the CPU, with the reference agreeing with the port."""
import json

import pytest

from fedbench_tiny import CELLS, ROOT, run_tiny
from fedbench import counts, families, harness
from fedbench.reference import family as reference_family

from test_fedbench_run import AGREE

TRAIN, SERVE, LONGDOC = CELLS


def agrees(res):
    assert res["correct"] is True and res["failed"] == 0
    for name, (value, limit) in res["checks"].items():
        assert value <= AGREE[name], (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_each_configuration_finds_its_family(cell):
    c = harness.load_cell(cell)
    fam = families.load(c.cfg)
    assert fam.shape_of(c.cfg) == counts.shape_of(c.cfg)
    assert callable(reference_family(c.cfg).layer)
    pcfg = harness.port_config(c.cfg, c.config_name)
    assert pcfg.family == c.cfg["port"]["family"] and pcfg.use_pallas and pcfg.remat
    assert (pcfg.n_layers, pcfg.d_model, pcfg.vocab_size) == (
        c.cfg["num_hidden_layers"], c.cfg["hidden_size"], c.cfg["vocab_size"])
    paths = {path for path, _, _ in fam.leaves(c.cfg)}
    assert ("unembed", "table") in paths and ("layers", 0, "attn", "wq") in paths


def test_the_port_block_passes_as_it_stands():
    cfg = json.loads((ROOT / "fedbench/configs/internlm2-20b.json").read_text())
    cfg["sliding_window"] = 4096
    cfg["port"] = {"family": "moe", "logit_softcap": 30.0, "mrope_sections": [1, 2, 3],
                   "moe": {"n_experts": 4, "top_k": 1}}
    with pytest.raises(ModuleNotFoundError):
        families.load(cfg)          # no such family module yet: a new file
    cfg["port"]["family"] = "dense"
    pcfg = harness.port_config(cfg, "x")
    assert pcfg.sliding_window == 4096 and pcfg.logit_softcap == 30.0
    assert pcfg.mrope_sections == (1, 2, 3)
    assert (pcfg.moe.n_experts, pcfg.moe.top_k) == (4, 1)
    assert counts.shape_of(cfg).window == 4096
    cfg["use_sliding_window"] = False
    assert harness.port_config(cfg, "x").sliding_window is None


def test_a_sliding_window_is_configuration_data():
    """The reference masks what the port's windowed attention masks."""
    agrees(run_tiny(LONGDOC, cfg_extra={"sliding_window": 16}))


def test_tied_embeddings_are_configuration_data():
    agrees(run_tiny(LONGDOC, cfg_extra={"tie_word_embeddings": True}))


@pytest.mark.parametrize("mix", [{"participation": 0.5, "clients": 4},
                                 {"agg_chunk": 2, "clients": 4},
                                 {"engine": "sequential"}],
                         ids=["half-sampled", "chunked", "sequential"])
def test_federated_mix_keys(mix):
    res = run_tiny(TRAIN, mix_extra=mix)
    agrees(res)
    share = mix.get("participation", 1.0)
    assert res["attempted"] % max(1, round(share * mix.get("clients", 3))) == 0
