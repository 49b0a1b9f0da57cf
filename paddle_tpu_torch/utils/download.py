"""Dataset and weight paths — counterpart of
`paddle_tpu/utils/download.py`: the same cache under
`~/.cache/paddle_tpu`, so both packages read one copy of a file.
`get_path_from_url` only resolves a cached file; it never fetches."""
import os

DATA_HOME = os.path.expanduser('~/.cache/paddle_tpu/dataset')


def get_weights_path_from_url(url, md5sum=None):
    return get_path_from_url(url,
                             os.path.expanduser('~/.cache/paddle_tpu/weights'))


def get_path_from_url(url, root_dir=DATA_HOME, md5sum=None, check_exist=True):
    fname = os.path.join(root_dir, url.split('/')[-1])
    if os.path.exists(fname):
        return fname
    raise RuntimeError(
        f"{url} is not cached at {fname} and network access is unavailable; "
        "place the file there manually")
