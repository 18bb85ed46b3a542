"""Pano360 acquisition from Flickr (reference
``scripts/download_flickr.py:49-237``): fetch the panorama set either by
an explicit photo-id list (``flickr_photo_ids.npy``) or by group/tag
scrape, saving the original-size image + EXIF JSON per photo.

Implemented against the plain Flickr REST API with ``requests`` (the
reference uses the ``flickrapi`` package, not present here). Requires
network access and a ``FLICKR_API_KEY`` env var; in offline environments
every call raises a clear error instead of hanging.

Port of ``spec_tpu/datagen/flickr.py``; ``requests`` is imported only
when a call is made, so importing this module touches no network.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

REST = 'https://api.flickr.com/services/rest/'


class FlickrDownloader:
    def __init__(self, api_key: Optional[str] = None,
                 out_folder: str = 'data/pano360/raw',
                 require_exif: bool = False,
                 originals_only: bool = True):
        self.api_key = api_key or os.environ.get('FLICKR_API_KEY', '')
        if not self.api_key:
            raise RuntimeError(
                'FLICKR_API_KEY not set — Pano360 download needs a Flickr '
                'API key (see reference scripts/download_flickr.py)')
        self.out_folder = out_folder
        self.require_exif = require_exif
        self.originals_only = originals_only
        os.makedirs(out_folder, exist_ok=True)

    def _call(self, method: str, **params):
        import requests

        params.update(dict(
            method=method, api_key=self.api_key, format='json',
            nojsoncallback=1))
        r = requests.get(REST, params=params, timeout=30)
        r.raise_for_status()
        return r.json()

    def download_by_ids(self, photo_ids: List[str]):
        """Reference photo-id-list path (:220-233)."""
        for pid in photo_ids:
            try:
                self._download_photo(str(pid))
            except Exception as e:
                print(f'[flickr] {pid}: {e}')

    def _download_pages(self, method: str, per_page: int, max_pages: int,
                        **params):
        """Shared paginate-and-download loop for the scrape paths."""
        for page in range(1, max_pages + 1):
            data = self._call(method, per_page=per_page, page=page,
                              **params)
            photos = data.get('photos', {}).get('photo', [])
            if not photos:
                break
            for p in photos:
                try:
                    self._download_photo(p['id'])
                except Exception as e:
                    print(f"[flickr] {p['id']}: {e}")

    def download_group(self, group_id: str, per_page: int = 500,
                       max_pages: int = 20):
        """Group-scrape path (:185-217)."""
        self._download_pages('flickr.groups.pools.getPhotos', per_page,
                             max_pages, group_id=group_id)

    def download_tag(self, tag: str, per_page: int = 500,
                     max_pages: int = 20):
        """Tag-scrape path (reference ``scrape_and_download`` with
        ``download_type='tag'``, :206-217): ``flickr.photos.search``
        over a tag, newest first."""
        self._download_pages('flickr.photos.search', per_page, max_pages,
                             tags=tag, sort='date-posted-desc')

    def _download_photo(self, photo_id: str):
        import requests

        sizes = self._call('flickr.photos.getSizes',
                           photo_id=photo_id)['sizes']['size']
        best = sizes[-1]
        if self.originals_only and best['label'] != 'Original':
            return
        exif = None
        try:
            exif = self._call('flickr.photos.getExif',
                              photo_id=photo_id)['photo']
        except Exception:
            if self.require_exif:
                return
        url = best['source']
        ext = os.path.splitext(url)[1] or '.jpg'
        img_path = os.path.join(self.out_folder, f'{photo_id}{ext}')
        with open(img_path, 'wb') as f:
            r = requests.get(url, timeout=60)
            r.raise_for_status()  # a 404/HTML error page is not a photo
            f.write(r.content)
        if exif is not None:
            with open(os.path.join(self.out_folder,
                                   f'{photo_id}_exif.json'), 'w') as f:
                json.dump(exif, f)


def main(argv=None):
    """CLI mirror of reference ``scripts/download_flickr.py`` (which
    hardcodes its choices in ``download()``/``scrape_and_download()``;
    exposed as flags here)."""
    import argparse

    parser = argparse.ArgumentParser(
        description='Pano360 Flickr downloader (needs $FLICKR_API_KEY)')
    parser.add_argument('--download_type', default='ids',
                        choices=['ids', 'group', 'tag'])
    parser.add_argument('--id_file', default='flickr_photo_ids.npy',
                        help="[ids] .npy photo-id list (the reference's "
                             'data/.../flickr_photo_ids.npy)')
    parser.add_argument('--group_id', default='',
                        help='[group] Flickr group id')
    parser.add_argument('--tag', default='people', help='[tag] tag name')
    parser.add_argument('--out_folder', default='data/pano360/raw')
    parser.add_argument('--max_pages', type=int, default=20)
    parser.add_argument('--require_exif', action='store_true',
                        help='skip photos without EXIF (reference '
                             'download_with_exif_only)')
    parser.add_argument('--any_size', action='store_true',
                        help='accept non-original sizes (reference '
                             'downloads originals only)')
    args = parser.parse_args(argv)

    dl = FlickrDownloader(out_folder=args.out_folder,
                          require_exif=args.require_exif,
                          originals_only=not args.any_size)
    if args.download_type == 'ids':
        import numpy as np
        dl.download_by_ids([str(i) for i in np.load(args.id_file)])
    elif args.download_type == 'group':
        if not args.group_id:
            raise SystemExit('--download_type group needs --group_id')
        dl.download_group(args.group_id, max_pages=args.max_pages)
    else:
        dl.download_tag(args.tag, max_pages=args.max_pages)


if __name__ == '__main__':
    main()
