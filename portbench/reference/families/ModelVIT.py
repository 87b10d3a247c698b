"""ModelVIT (the reference repository's ``modelv3.py``) in plain float32:
``reference/model.py``'s ``Net.model_vit`` over its layout."""

from portbench.reference.model import Net
from portbench.reference.model import model_vit_shapes as shapes  # noqa: F401


def logits(w, cfg, img, masks, q):
    return Net(w, cfg, masks, q).model_vit(img)
