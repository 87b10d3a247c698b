"""ModelCross (the reference repository's ``model_cross.py``) in plain
float32: ``reference/model.py``'s ``Net.model_cross`` over its layout."""

from portbench.reference.model import Net
from portbench.reference.model import model_cross_shapes as shapes  # noqa: F401


def logits(w, cfg, img, masks, q):
    return Net(w, cfg, masks, q).model_cross(img)
