"""Filesystem helpers mirroring the reference's checkpoint-dir hygiene
(reference: src/algorithm/tools/utils.py:107-160). A copy of
``nes_img_captioning_tpu/utils/files.py``."""

from __future__ import annotations

import os
import re
import shutil

__all__ = [
    "mkdir_p",
    "copy_file_from_to",
    "remove_all_files_but",
    "remove_all_files_from_dir",
    "remove_file_if_exists",
    "remove_file_with_pattern",
    "find_file_with_pattern",
]


def mkdir_p(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def copy_file_from_to(src: str, dst: str):
    shutil.copy(src=src, dst=dst)


def remove_all_files_but(from_dir: str, but_list):
    keep = set(but_list)
    for name in os.listdir(from_dir):
        path = os.path.join(from_dir, name)
        if os.path.isfile(path) and path not in keep:
            os.remove(path)


def remove_all_files_from_dir(from_dir: str):
    for name in os.listdir(from_dir):
        path = os.path.join(from_dir, name)
        if os.path.isfile(path):
            os.remove(path)


def remove_file_if_exists(path: str):
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def remove_file_with_pattern(pattern: str, directory: str):
    for name in os.listdir(directory):
        if re.search(pattern, name):
            os.remove(os.path.join(directory, name))


def find_file_with_pattern(pattern: str, directory: str):
    for name in os.listdir(directory):
        if re.search(pattern, name):
            return name
    return None
