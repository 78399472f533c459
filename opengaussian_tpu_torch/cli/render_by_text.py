"""Text query -> 3D object selection -> rendered object and mask PNGs.

Port of opengaussian_tpu/cli/render_by_text.py (reference
render_lerf_by_text.py, selection at :102-115): the cosine similarity of a
CLIP text feature with the per-leaf language features of cluster_lang.npz
picks the best leaf; of the top 10 candidates, those in the same root
window whose codebook features lie within 0.9 join it. The union is
rendered as RGB on a white background with the leaf-level scale cull and
the KNN outlier mask, with the silhouette > 0.7 as the predicted mask:

    python -m opengaussian_tpu_torch.cli.render_by_text -m <model> -s <scene> \\
        --scene_name teatime --text_features text_features.json [--texts ...]

CLIP text features come from a JSON {text: [512 floats]} file, or a .zip
holding one (the reference's assets/text_features.zip). Each (text, frame)
is one render_selection call, i.e. one K1 launch on the GPU. Writes
text2obj/ours_<it>/renders_cluster/ and renders_cluster_silhouette/.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

SCENE_TEXTS = {
    "waldo_kitchen": ["Stainless steel pots", "dark cup", "refrigerator", "frog cup",
                      "pot", "spatula", "plate", "spoon", "toaster", "ottolenghi",
                      "plastic ladle", "sink", "ketchup", "cabinet", "red cup",
                      "pour-over vessel", "knife", "yellow desk"],
    "ramen": ["nori", "sake cup", "kamaboko", "corn", "spoon", "egg",
              "onion segments", "plate", "napkin", "bowl", "glass of water",
              "hand", "chopsticks", "wavy noodles"],
    "figurines": ["jake", "pirate hat", "pikachu", "rubber duck with hat",
                  "porcelain hand", "red apple", "tesla door handle", "waldo",
                  "bag", "toy cat statue", "miffy", "green apple", "pumpkin",
                  "rubics cube", "old camera", "rubber duck with buoy",
                  "red toy chair", "pink ice cream", "spatula",
                  "green toy chair", "toy elephant"],
    "teatime": ["sheep", "yellow pouf", "stuffed bear", "coffee mug",
                "tea in a glass", "apple", "coffee", "hooves", "bear nose",
                "dall-e brand", "plate", "paper napkin", "three cookies",
                "bag of cookies"],
}
SCENE_EVAL_FRAMES = {
    "waldo_kitchen": ["frame_00053", "frame_00066", "frame_00089", "frame_00140", "frame_00154"],
    "ramen": ["frame_00006", "frame_00024", "frame_00060", "frame_00065",
              "frame_00081", "frame_00119", "frame_00128"],
    "figurines": ["frame_00041", "frame_00105", "frame_00152", "frame_00195"],
    "teatime": ["frame_00002", "frame_00025", "frame_00043", "frame_00107",
                "frame_00129", "frame_00140"],
}
MIN_OCCU = 5  # reference render_lerf_by_text.py:62
CAND_DIST = 0.9


def select_leaves_by_text(text_feat: np.ndarray, lang: dict, leaf_centers: np.ndarray,
                          leaf_num: int) -> np.ndarray:
    """-> array of selected leaf ids, the best first (reference :102-115)."""
    leaf_feat = lang["leaf_feat"].copy()
    leaf_feat[lang["occu_count"] < MIN_OCCU] = 0.0
    t = text_feat / (np.linalg.norm(text_feat) + 1e-12)
    f = leaf_feat / (np.linalg.norm(leaf_feat, axis=1, keepdims=True) + 1e-12)
    sim = f @ t  # [k1*k2]
    max_id = int(np.argmax(sim))
    selected = [max_id]
    top = np.argsort(-sim)[:10]
    for cand in top[1:]:
        if cand - max_id < leaf_num:  # same-root window, as the reference
            d = np.linalg.norm(leaf_centers[max_id] - leaf_centers[int(cand)])
            if d < CAND_DIST:
                selected.append(int(cand))
    return np.asarray(selected)


def load_text_features(path: str) -> dict:
    """{text: [512 floats]} from a JSON file, or from the one JSON file of a
    .zip (the reference ships assets/text_features.zip and unzips it at
    load, render_lerf_by_text.py:69-72)."""
    if path.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(path) as z:
            name = next(n for n in z.namelist() if n.endswith(".json"))
            return json.loads(z.read(name))
    with open(path) as f:
        return json.load(f)


def main(argv=None, device="cuda") -> list[dict]:
    """Parse the flags and render every text query on `device`. -> one
    record per query answered: text, leaves, the splats selected before
    and after the KNN mask, those of them that pass the scale cull, the
    frames rendered, and host seconds of the leaf choice, the KNN mask and
    each frame's render (to its PNG, which waits for the device)."""
    from PIL import Image

    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.device import resolve_device
    from opengaussian_tpu_torch.models.loading import load_cluster_lang, load_model
    from opengaussian_tpu_torch.ops.knn import selection_mask
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import passes_scale_cull, render_selection, save_selection

    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--scene_name", required=True)
    p.add_argument("--text_features", required=True, help="json {text: [512]} or a .zip of one")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--texts", nargs="*", default=None)
    p.add_argument("--frames", nargs="*", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    scene = load_scene(args.source_path, eval_split=False, resolution=args.resolution)
    state, kms, it = load_model(args.model_path, args.iteration, device=dev)
    lang = load_cluster_lang(args.model_path)
    tf = load_text_features(args.text_features)
    texts = args.texts or SCENE_TEXTS.get(args.scene_name, list(tf))
    frames = args.frames or SCENE_EVAL_FRAMES.get(args.scene_name)
    k1 = kms.centers.shape[0]
    leaf_num = lang["leaf_feat"].shape[0] // k1
    leaf_centers = kms.leaf_centers.cpu().numpy()
    leaf_ids = kms.leaf_cls_ids.cpu().numpy()
    alive = state.alive.cpu().numpy()
    means = state.means.cpu().numpy()
    small = passes_scale_cull(state).cpu().numpy()

    out_rgb = os.path.join(args.model_path, "text2obj", f"ours_{it}", "renders_cluster")
    out_sil = os.path.join(args.model_path, "text2obj", f"ours_{it}",
                           "renders_cluster_silhouette")
    os.makedirs(out_rgb, exist_ok=True)
    os.makedirs(out_sil, exist_ok=True)

    rcfg = RasterizeConfig()
    bg = torch.ones(3, device=dev)  # the reference renders selections on white
    records = []
    for text in texts:
        if text not in tf:
            print(f"[skip] no text feature for {text!r}")
            continue
        t0 = time.perf_counter()
        sel = select_leaves_by_text(np.asarray(tf[text], np.float32), lang,
                                    leaf_centers, leaf_num)
        t1 = time.perf_counter()
        member, n_before = selection_mask(leaf_ids, alive, means, sel)
        t2 = time.perf_counter()
        rec = dict(text=text, leaves=sel.tolist(), members=n_before,
                   after_knn=int(member.sum()), after_cull=int((member & small).sum()),
                   frames=[], select_s=t1 - t0, knn_s=t2 - t1, render_s=[])
        print(f"query {text!r} -> leaves {rec['leaves']}: {n_before} splats, "
              f"{rec['after_knn']} after the KNN mask, {rec['after_cull']} of them "
              f"under the scale cull")
        member_t = torch.as_tensor(member, device=dev)
        with torch.no_grad():
            for v in scene.train_views:
                if frames and v.image_name not in frames:
                    continue
                t0 = time.perf_counter()
                out = render_selection(v.camera, state, bg, member_t, rcfg)
                name = f"{v.image_name}_{text}.png"
                save_selection(os.path.join(out_rgb, name), out.cluster_imgs)
                sil = (out.cluster_silhouettes > 0.7).cpu().numpy().astype(np.uint8) * 255
                Image.fromarray(sil).save(os.path.join(out_sil, name))
                rec["render_s"].append(time.perf_counter() - t0)
                rec["frames"].append(v.image_name)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
