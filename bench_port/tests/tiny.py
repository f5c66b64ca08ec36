"""A tiny copy of the benchmark's registry on the CPU: the tiny model
configs (the program's ``tiny()`` constructors), float32, a 4-frame and a
2-row traffic mix of a few steps, and cells whose limits fit float32
against float32. The harness runs them end to end without a card."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

TINY = {
    "source": "tiny test configuration",
    "unet": {"sample_size": 16, "in_channels": 4, "out_channels": 4,
             "block_out_channels": [32, 64],
             "down_block_types": ["down", "crossattn"],
             "up_block_types": ["crossattn", "up"], "layers_per_block": 1,
             "transformer_layers_per_block": [1, 1],
             "num_attention_heads": [2, 4], "cross_attention_dim": 32,
             "norm_num_groups": 8, "norm_eps": 1e-05,
             "addition_time_embed_dim": 8,
             "projection_class_embeddings_input_dim": 80,
             "flip_sin_to_cos": True, "freq_shift": 0,
             "use_motion_modules": True, "motion_num_attention_heads": 8,
             "motion_max_seq_length": 32,
             "motion_transformer_layers_per_block": 1,
             "motion_mid_block": False},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 32], "layers_per_block": 1,
            "norm_num_groups": 8, "scaling_factor": 0.13025},
    "clip_l": {"vocab_size": 1000, "hidden_size": 16,
               "intermediate_size": 32, "num_layers": 2, "num_heads": 2,
               "max_position_embeddings": 77, "hidden_act": "quick_gelu",
               "projection_dim": None, "layer_norm_eps": 1e-05},
    "clip_g": {"vocab_size": 1000, "hidden_size": 16,
               "intermediate_size": 32, "num_layers": 2, "num_heads": 2,
               "max_position_embeddings": 77, "hidden_act": "gelu",
               "projection_dim": 32, "layer_norm_eps": 1e-05},
    "unziplora": {"rank": 4, "merge_spread": 0.25},
    "dtypes": {"unet": "float32", "clip": "float32", "vae": "float32",
               "lora": "float32"},
}

LIMITS = {"start": 0, "euler": 0, "eps": 1e-4, "decode": 1e-4, "frames": 0}


def tiny_traffic(pipeline: str) -> dict:
    base = json.load(open(HERE / "traffic" / (
        "video_both_16f_1024.json" if pipeline == "video"
        else "image_both_4seeds_1024.json")))
    base.update(height=32, width=32, steps=3)
    if pipeline == "video":
        base.update(frames=4)
    else:
        base.update(noise_seeds=[0, 1000])
    return base


def make_root(tmp: Path, cells: dict) -> Path:
    """A checkout-like directory: BENCHMARK.json and bench_port/ with the
    real metric readers and the given cells {name: (config, traffic
    dict, pipeline)}."""
    here = tmp / "bench_port"
    for sub in ("configs", "traffic", "cells"):
        (here / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", here / "metrics")
    bench = json.load(open(HERE.parent / "BENCHMARK.json"))
    (here / "configs" / "tiny.json").write_text(json.dumps(TINY))
    bench["configs"] = [{"name": "tiny", "source": "tiny",
                         "file": "bench_port/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = []
    for name, (traffic, pipeline) in cells.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (here / "cells" / f"{name}.json").write_text(json.dumps(
            {"eps_steps": 2, "limits": LIMITS}))
        bench["workloads"].append(
            {"name": name, "config": "tiny", "traffic": name, "chips": 1,
             "why": "tests"})
        metric = "video_s" if pipeline == "video" else "image_s"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                ref = ("video_both_16f_1024" if pipeline == "video"
                       else "image_both_4seeds_1024")
                if ref in m["workloads"]:
                    m["workloads"].append(name)
        assert any(m["name"] == metric for m in bench["end_to_end"])
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp

