"""Source-code archiving into the run dir for reproducibility
(reference utils/gen_code_archive.py:19-32; a copy of
``semivl_tpu/utils/code_archive.py``)."""

import os
import tarfile


def is_source_file(path):
    return path.endswith(('.py', '.yaml', '.yml', '.sh', '.md', '.txt')) \
        and '.git' not in path


def gen_code_archive(out_dir, repo_root=None, file_name='code.tar.gz'):
    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    archive = os.path.join(out_dir, file_name)
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(archive, mode='w:gz') as tar:
        for root, dirs, files in os.walk(repo_root):
            dirs[:] = [d for d in dirs
                       if d not in ('.git', '__pycache__', 'exp',
                                    '.jax_cache', 'assets', '_build',
                                    '.scratch')]
            for f in files:
                full = os.path.join(root, f)
                if is_source_file(full):
                    tar.add(full, arcname=os.path.relpath(full, repo_root))
    return archive
